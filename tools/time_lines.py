"""Runs a command and prints each line of its output (standard output and
standard error together) with the seconds since the command started, so a
long log such as `chip_smoke.py`'s shows where its time went (a Python
command runs unbuffered).

    python tools/time_lines.py -- python3 chip_smoke.py > smoke.log

Exits with the command's own code.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            bufsize=1, env={**os.environ, "PYTHONUNBUFFERED": "1"})
    for line in proc.stdout:
        print(f"{time.perf_counter() - t0:9.1f} {line}", end="", flush=True)
    return proc.wait()


if __name__ == "__main__":
    raise SystemExit(main())
