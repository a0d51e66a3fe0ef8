"""I/O layer: QPS reader/writer and Maros-Meszaros corpus tooling."""
from .maros_meszaros import (MAROS_MESZAROS, MarosMeszarosEntry,
                             default_subset, load_corpus, run_corpus)
from .qps import QPSData, parse_qps, read_qps, write_qps

__all__ = [
    "QPSData",
    "parse_qps",
    "read_qps",
    "MAROS_MESZAROS",
    "MarosMeszarosEntry",
    "default_subset",
    "run_corpus",
    "load_corpus",
    "write_qps",
]
