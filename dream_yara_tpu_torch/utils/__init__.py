from .alphabet import (
    A, C, G, T, N, SENTINEL, SIGMA,
    ascii_to_code, code_to_ascii, encode, decode, complement, revcomp,
    pack_2bit, unpack_2bit,
)
from .timer import StageTimers
from .options import MapperOptions
