"""control.py for the traffic kinds whose runner carries its own control
(`VARIANTS` and `control(torch, cell, config, seed, device, variants)` in
traffic/<kind>.py): the reference in bfloat16, and the faults the cell
can have, each in the program's place and judged by the harness's own
verdict (`run.verdict`), which has to read `correct: false`.

    python3 portbench/control_kinds.py --workload <cell> --seeds <n> ... \
        [--variants <variant> ...]

prints what control.py prints: a JSON line a seed and variant, then for
each variant whether every seed came out not correct and the least
reading of each number. It exits 1 if a variant came out correct on any
seed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from portbench import common  # noqa: E402
from portbench.run import compared_line, load_module, verdict  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["bf16"])
    args = ap.parse_args(argv)
    common.cache_env()
    cell, config = common.load_cell(args.workload)
    kind = load_module(BENCH / "traffic" / f"{cell['traffic_kind']}.py",
                       "portbench_traffic_" + cell["traffic_kind"])
    unknown = set(args.variants) - set(kind.VARIANTS)
    if unknown:
        ap.error(f"variants of {cell['traffic_kind']}: {kind.VARIANTS}")
    import torch
    common.require_cards(torch, cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {v: dict(all_not_correct=True, least={})
               for v in args.variants}
    for seed in args.seeds:
        got = kind.control(torch, cell, config, seed, "cuda", args.variants)
        for variant, cmp in got.items():
            correct = verdict(cmp)
            print(json.dumps(dict(seed=seed, variant=variant,
                                  correct=correct,
                                  compared=compared_line(cmp))), flush=True)
            s = summary[variant]
            s["all_not_correct"] = s["all_not_correct"] and not correct
            for name, value, *_ in cmp:
                s["least"][name] = min(s["least"].get(name, math.inf),
                                       value)
    print(json.dumps(dict(workload=args.workload, seeds=args.seeds,
                          variants=summary)))
    return 0 if all(s["all_not_correct"] for s in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
