"""The control of the comparison that decides `correct`, on the chip at a
cell's own size: for each seed, one run of the cell (set-up, a window of
`--seconds`), then the compared numbers of the port and of the control
(the reference computed with TF32 on, put in the port's place) over the
same sampled calls. One JSON line a seed.

    python3 -m slambench.control --workload <cell> --seeds 1,2,3 --seconds 20

The benchmark's own runs do not run it."""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    a = ap.parse_args(argv)
    from slambench import run
    for seed in (int(s) for s in a.seeds.split(",")):
        res = run.run(a.workload, seed, a.seconds, trace=False, control=True,
                      emit=lambda line: print(line, file=sys.stderr))
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "port": {k: v["value"] for k, v in res["checks"].items()},
                          "control": res["control"],
                          "frames_per_s": res["metrics"]["frames_per_s"]["value"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
