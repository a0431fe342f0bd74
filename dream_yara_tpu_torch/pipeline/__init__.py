"""Mapper stages of the port: seeding, the single-bin map step, the chunked
bin mapper, mate rescue, prefilter routing and the DREAM stream, and the
host post-processing (matches, MAPQ, CIGAR, pairing, SAM)."""
