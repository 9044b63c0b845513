# Copy of tntblast_tpu/io/__init__.py with the package name changed.
from .fastx import SequenceDatabase, seq_len_increment  # noqa: F401
