"""Mapper stages of the port: seeding, the single-bin map step, the chunked
bin mapper, mate rescue, prefilter routing and the DREAM stream. Host
post-processing (matches, MAPQ, CIGAR, pairing, SAM) is the reference's,
shared through `dream_yara_tpu_torch._shared`."""
