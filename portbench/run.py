"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. With ``--trace 0`` the line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics from a traced slice. The last
line of standard output is one JSON object; the last lines of standard
error give each number the check compared, beside its limit.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open('/proc/self/stat') as f:
            start = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


_T_PROCESS = _T0 - _age()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.harness import cell, manifest as mf
    manifest = mf.load()
    chips = mf.workload(manifest, args.workload)['chips']

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA card(s); this machine '
              f'has {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), 'cuda', _T_PROCESS, manifest)
    found = cell.forbidden_modules()
    if found:
        print(f'loaded after the window: {", ".join(found)}',
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for name, c in result['checks'].items():
        print(f'check {name} = {c["value"]!r}, limit {c["limit"]!r}',
              file=sys.stderr)
    print(f'correct = {result["correct"]}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
