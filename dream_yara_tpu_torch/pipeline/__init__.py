"""Mapper stages of the port: seeding, the single-bin map step, the chunked
bin mapper and the DREAM stream. Host post-processing (matches, MAPQ,
CIGAR, SAM) is the reference's, shared through `dream_yara_tpu_torch._shared`."""
