"""Operations and bytes of the program's kernels, one file per kernel,
and the table of the card's peaks (``peaks.py``)."""
