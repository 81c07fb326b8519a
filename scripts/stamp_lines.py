#!/usr/bin/env python3
"""Prefix each line of standard input with the seconds since this script
started, and write it to standard output at once. Pipe a run through it to
see when each phase ended, e.g.

    python3 chip_smoke.py 2>&1 | python3 scripts/stamp_lines.py > run.log
"""

import sys
import time


def main() -> int:
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
