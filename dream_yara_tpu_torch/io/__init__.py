from .fasta import read_fasta, write_fasta
from .fastq import read_fastq, FastqBatchReader
from .seqstore import SeqStore
from .readstore import ReadBatch
