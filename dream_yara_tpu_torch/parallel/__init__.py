"""The DREAM mesh path of the port: the flat multi-bin step of one device
(dist_mapper) and its host driver (dream_mesh), on a (data=1, bin=1)
layout until the multi-GPU edition."""
