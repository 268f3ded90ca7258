"""The readings the check's limits are set from, many seeds in one
process: for each seed, the program's numbers after a short window at
the cell's own sizes and load, and the control's, the plain reference
put in the program's place and computed one precision below the
configuration's (float32 with TF32 products, where the configuration
states float32 with TF32 off), judged by the same float64 reference.

    python3 -m portbench.tools.readings --workload panda_dh.sweep \
        --seeds 101 102 103 --control-seeds 101 102 103 [--requests 2]

One JSON line per seed and side on standard output, then a summary of
the largest reading of each number on each side. ``--faults`` reads the
faults of the cell's kind (``FAULTS`` in ``kinds/<kind>.py``) on the
control seeds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from portbench.harness import cell, manifest as mf  # noqa: E402


class Patches:
    """``patch(obj, name, value)`` outside pytest, undone by ``undo``."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control-seeds', type=int, nargs='*', default=())
    ap.add_argument('--requests', type=int, default=None)
    ap.add_argument('--faults', nargs='*', default=(),
                    help="faults of the kind's FAULTS to read, each on "
                         'the control seeds')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    manifest = mf.load()
    kind_name = mf.mix(mf.workload(manifest, args.workload)['traffic'])[
        'kind']
    module = mf.kind(kind_name)
    n = args.requests or module.READINGS_REQUESTS
    worst = {'program': {}, 'control': {}}
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, _, _, kind = cell.build(args.workload, seed, args.device,
                                   manifest)
        w = cell.Window(kind, requests=n)
        kind.window_closed()
        sides = {'program': kind.check()}
        sides['program'].update(getattr(kind, 'read_only', {}))
        if seed in args.control_seeds:
            sides['control'] = kind.control()
        for side, nums in sides.items():
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'side': side, 'failed': w.failed,
                              'attempted': w.attempted,
                              'seconds': time.perf_counter() - t0,
                              **nums}), flush=True)
            for k, v in nums.items():
                worst[side][k] = max(worst[side].get(k, v), v)
        del kind
        if args.device == 'cuda':
            torch.cuda.empty_cache()
    for name in args.faults:
        for seed in args.control_seeds:
            patches = Patches()
            module.FAULTS[name](patches.set)
            try:
                _, _, _, kind = cell.build(args.workload, seed, args.device,
                                           manifest)
                cell.Window(kind, requests=n)
                kind.window_closed()
                nums = kind.check()
            finally:
                patches.undo()
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'side': f'fault:{name}', **nums}), flush=True)
            del kind
    print(json.dumps({'workload': args.workload, 'worst': worst}),
          flush=True)


if __name__ == '__main__':
    main()
