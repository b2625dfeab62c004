"""Run a command and time the phases of its output.

    python3 tools/phase_walls.py LOG -- python3 chip_smoke.py

Each line the command prints to its standard output is passed through and
written to LOG with the seconds since the start in front. A phase is the
run of lines from the first that starts with ``[N]`` (``chip_smoke.py``'s
phase tags) to the first line of the next phase tag to appear; its wall is
the time between the two (the last phase ends when the command does). At
the end one JSON line gives each phase's wall in seconds, in the order the
phases appeared, and the command's total. The exit code is the command's.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

TAG = re.compile(r"^\[(\d+)\]")


def main(argv: list) -> int:
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__, file=sys.stderr)
        return 2
    log_path, cmd = argv[0], argv[2:]
    t0 = time.perf_counter()
    starts = {}  # phase tag -> seconds of its first line, in order of appearance
    with open(log_path, "w") as log, subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                                      bufsize=1) as proc:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            sys.stdout.write(line)
            log.write(f"{t:10.3f} {line}")
            m = TAG.match(line)
            if m and m.group(1) not in starts:
                starts[m.group(1)] = t
        rc = proc.wait()
    total = time.perf_counter() - t0
    tags = list(starts)
    ends = [starts[n] for n in tags[1:]] + [total]
    walls = {n: round(end - starts[n], 3) for n, end in zip(tags, ends)}
    print(json.dumps({"phase_walls_s": walls, "total_s": round(total, 3), "rc": rc}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
