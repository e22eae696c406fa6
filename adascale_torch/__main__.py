"""``python -m adascale_torch``: the command line (``cli.py``)."""
import sys

from .cli import main

main(sys.argv[1:])
