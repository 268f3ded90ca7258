"""A/B of kernel B1 against its dual half-tile variants (kernel B6,
``csrc/dh_dual_score.cu``): the PyTorch counterpart of the JAX package's
``scripts/ab_dual_tile.py``.

    python3 -m diffco_tpu_torch.scripts.ab_dual_tile [--out PATH]

The reference splits each TPU batch tile into two halves and runs them in
sequence (``dual_seq``, the control) or with their stages interleaved
(``dual_pipe``). On the card a block takes a tile of 256 configurations
as two halves of 128, each computed as a block of B1's tensor-core kernel
computes it: ``dual_seq_256`` runs one half's FK, support loop and
backward, then the other's; ``dual_pipe_256`` gives the FK and the
backward a warpgroup of their own, which runs half B's FK and half A's
backward while the tensor-core warps run the other half's support loop;
``dual_pipe_persist`` does the same with one block per SM walking many
halves, each half's FK and backward hidden behind its neighbours' loops.

At the roofline shape (PandaFK, B = 65536, S = 512) it checks each variant
against the production kernel (``fk_score.dh_score_grad``) on the first
4096 configurations, then times the production kernel and each variant by
scan differencing (``roofline_fk_score.per_step_ms``; a step is
``q - 1e-4 dq``) and by their own time on the card
(``roofline_fk_score.device_ms``). The result goes to ``--out`` (default
``build/diffco_tpu_torch/roofline_dual_tile.json``) and is printed as JSON
with the card's name and power limit. ``--device cpu`` runs the plain twin
as a rehearsal.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..ops import fk_score
from . import roofline_fk_score as rf

# name (by rows per tile; the persistent form walks many) ->
# csrc/dh_dual_score.cu's variant
VARIANTS = {'dual_seq_256': 0, 'dual_pipe_256': 1, 'dual_pipe_persist': 2}
N_CHECK = 4096


def dh_dual_score_grad(q, s, w, spec, variant='dual_pipe_256'):
    """Kernel B6: B1's function, q [B, J] -> (score [B], dq [B, J]), in
    the ``variant`` of ``VARIANTS``. A CUDA tensor launches
    ``csrc/dh_dual_score.cu``, counted in
    ``launches.dh_dual_score_grad:<variant>`` (or raises); a CPU tensor
    runs B1's plain twin, ``fk_score._dh_score_grad_plain``."""
    if variant not in VARIANTS:
        raise ValueError(f'dh_dual_score_grad: variant {variant!r}, not one '
                         f'of {list(VARIANTS)}')
    if q.device.type == 'cpu':
        return fk_score._dh_score_grad_plain(q, s, w, spec)
    c = rf.fp24_spec('dh_dual_score_grad', spec)
    return fk_score._launch(f'dh_dual_score_grad:{variant}', 'dh_dual_score',
                            q, s, w, c, c.J, c.P, VARIANTS[variant],
                            entry='dh_dual_score_grad')


def run(device='cuda', batch=rf.B, supports=rf.S):
    """The A/B result dict (module docstring) at ``batch`` x
    ``supports``; the step counts as ``roofline_fk_score.per_step_ms``."""
    dev = resolve_device(device)
    robot, sup, w = rf.flagship_score_setup(supports, device=dev)
    spec = fk_score.robot_spec(robot)
    q = robot.rand_configs(batch, torch.Generator().manual_seed(1), dev)
    out = dict(B=batch, S=supports, device=str(dev))

    def timed(score_grad):
        return rf.per_step_ms(lambda x: x - 1e-4 * score_grad(x)[1], q)

    qc = q[:N_CHECK]
    sc0, dq0 = fk_score.dh_score_grad(qc, sup, w, spec)
    variants = {}
    for name in VARIANTS:
        sc1, dq1 = dh_dual_score_grad(qc, sup, w, spec, name)
        variants[name] = dict(
            max_abs_score_err_vs_prod=float((sc1 - sc0).abs().max()),
            rel_grad_err_vs_prod=float((dq1 - dq0).abs().max()
                                       / dq0.abs().max()))
    t_prod, out['prod_raw_ms'] = timed(
        lambda x: fk_score.dh_score_grad(x, sup, w, spec))
    out['prod_ms'] = t_prod
    on_card = dev.type == 'cuda'
    out['prod_device_ms'] = (rf.device_ms(
        lambda: fk_score.dh_score_grad(q, sup, w, spec), 'dh_score_tc_kernel')
        if on_card else None)
    for name in VARIANTS:
        t, raw = timed(lambda x, v=name: dh_dual_score_grad(
            x, sup, w, spec, v))
        variants[name].update(ms_per_step=t, raw_ms=raw, speedup_vs_prod=(
            t_prod / t if t and t_prod else None), device_ms=(rf.device_ms(
                lambda v=name: dh_dual_score_grad(q, sup, w, spec, v),
                rf.instance_pattern('dh_dual_score_tc_kernel',
                                    VARIANTS[name])) if on_card else None))
    out['variants'] = variants
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out',
                    default=str(rf.OUT_DIR / 'roofline_dual_tile.json'))
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--batch', type=int, default=rf.B)
    ap.add_argument('--supports', type=int, default=rf.S)
    args = ap.parse_args(argv)
    res = run(args.device, args.batch, args.supports)
    res.update(rf.card_info(torch.device(args.device)))
    rf.write_result(res, args.out)
    print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
