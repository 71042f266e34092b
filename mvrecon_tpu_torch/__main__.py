import sys

from .cli import build_parser, main  # noqa: F401 (importable from here too)

if __name__ == "__main__":
    sys.exit(main())
