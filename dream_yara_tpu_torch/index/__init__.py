from .suffix_array import build_suffix_array
from .fmindex import FMIndex
from .ibf import InterleavedBloomFilter
from .kdx import DirectKmerFilter
