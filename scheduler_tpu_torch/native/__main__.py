"""``python -m scheduler_tpu_torch.native --build`` compiles the C++ library."""

from __future__ import annotations

import argparse
import sys

from scheduler_tpu_torch.native import available, build


def main() -> int:
    parser = argparse.ArgumentParser(prog="scheduler_tpu_torch.native")
    parser.add_argument("--build", action="store_true", help="compile the shared library")
    parser.add_argument("--force", action="store_true", help="rebuild even if up to date")
    args = parser.parse_args()
    if args.build:
        print(f"built {build(force=args.force)}")
        return 0
    print(f"native available: {available()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
