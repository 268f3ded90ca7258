"""A/B of kernel B5 (``csrc/chain_multi_score.cu``) against other builds
of the same C entry, on one card in one process.

    python3 -m diffco_tpu_torch.scripts.ab_kernel --source OTHER.cu \
        [--classes 5 8] [--out PATH]
    python3 -m diffco_tpu_torch.scripts.ab_kernel --ablate noA noB ...

``--source OTHER.cu`` is any source that defines ``chain_multi_score_grad``
with the production signature, for example the file as an earlier commit
had it (``git archive`` into an ignored directory); it is held against
the plain twin (score 1e-4, dq 1e-3, as chip_smoke.py) before it is
timed. ``--ablate`` builds copies of ``csrc/`` with one part of the
kernel taken out (``ABLATIONS``: phase A, phase B, the class table, the
compensated score, the epilogue), which attributes the production
kernel's time to its parts; their results are wrong by design and are
not checked. Every build uses the flags of ``ops/_native.py`` and is
launched as the production wrapper launches, outputs allocated per call.

The shape is the FrankaPanda multi-class path's (B = 65573, S = 1024
supports that are FK points of random configurations, weights
N(0, 0.05^2), seeds fixed). Each build is timed against the production
kernel in turns (production, other, other, production; CUDA events, 50
launches after 5 warm-ups each). The result goes to ``--out`` (default
``build/diffco_tpu_torch/ab_kernel.json``) and is printed as JSON with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
from pathlib import Path

import torch

from ..ops import _native, fk_score
from ..robots.urdf import FrankaPanda
from .roofline_fk_score import card_info, write_result

B, S = 65536 + 37, 1024
_MSB, _KER = 'multi_score_block.cuh', 'chain_multi_score.cu'
# name -> (file, text, replacement): each takes one part of the kernel out
ABLATIONS = {
    'noA': (_MSB, 'for (int jj = 0; jj < KH; ++jj) {',
            'for (int jj = 0; jj < 0; ++jj) {'),
    'noB': (_MSB, 'for (int k = 0; k < K; ++k) {',
            'for (int k = 0; k < 0; ++k) {'),
    'noZ': (_MSB, 'for (int i = 0; i < K * kMultiCols / kMultiThreads; ++i) {',
            'for (int i = 0; i < 0; ++i) {'),
    'noTwoSum': (_MSB,
                 'two_sum_add(wb[j * kWStride + k0 + c] * r, sc[c], comp[c]);',
                 'sc[c] = fmaf(wb[j * kWStride + k0 + c], r, sc[c]);'),
    'noEpilogue': (_KER, 'if (quarter >= cg) continue;', 'continue;'),
}


def _build(source):
    src = Path(source).resolve()
    h = hashlib.sha256()   # the source and every header beside it
    for p in sorted(src.parent.glob('*.cu*')):
        h.update(p.name.encode() + p.read_bytes())
    tag = h.hexdigest()[:12]
    out = _native._BUILD / f'ab-{src.stem}-{tag}.so'
    if not out.exists():
        _native._BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run([_native._nvcc(), *_native._NVCC_FLAGS, '-o',
                        str(out), str(src)], check=True,
                       capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).chain_multi_score_grad
    fn.argtypes = _native.build()['chain_multi_score'] \
        .chain_multi_score_grad.argtypes
    fn.restype = ctypes.c_int
    return fn


def _ablated(name):
    """csrc/ copied to the build directory with ABLATIONS[name] applied;
    the path of its chain_multi_score.cu."""
    fname, text, repl = ABLATIONS[name]
    d = _native._BUILD / f'ablate-{name}'
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_native._CSRC, d)
    body = (d / fname).read_text()
    if text not in body:
        raise RuntimeError(f'ablation {name}: {text!r} not in {fname}')
    (d / fname).write_text(body.replace(text, repl))
    return d / _KER


def _time_ms(fn, warmup=5, iters=50):
    for _ in range(warmup):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def run(builds, classes=(5, 8)):
    """{name: (source, check)} timed against production (module
    docstring)."""
    dev = torch.device('cuda')
    fns = {name: (_build(src), check) for name, (src, check) in
           builds.items()}
    robot = FrankaPanda(load_gripper=True, device=dev)
    cs = fk_score.robot_chain_statics(robot)
    c = fk_score._c_chain_spec(cs)
    g = torch.Generator().manual_seed(0)
    q = robot.rand_configs(B, g, dev)
    sup = robot.fkine(robot.rand_configs(S, g, dev)).reshape(S, -1)
    res = dict(shape=dict(B=B, S=S, P=c.P, D=c.D), classes={})
    for C in classes:
        W = (torch.randn(S, C, generator=g) * 0.05).to(dev)
        args = (q, sup.contiguous(), W)
        ref, ref_dq = fk_score._chain_multi_score_grad_plain(*args, cs)

        def prod():
            return fk_score.chain_multi_score_grad(*args, cs)

        out = res['classes'][C] = {}
        for name, (fn, check) in fns.items():
            def alt(fn=fn):   # as the wrapper: allocate, launch, check
                score = q.new_empty((B, C))
                dq = q.new_empty((C, B, c.D))
                _native.raise_on_error(f'chain_multi_score_grad ({name})', fn(
                    *(t.data_ptr() for t in (*args, score, dq)), B, S, C,
                    ctypes.byref(c),
                    torch.cuda.current_stream(dev).cuda_stream))
                return score, dq
            row = {}
            for who, f in (('production', prod), (name, alt)):
                if who == name and not check:
                    continue
                score, dq = f()
                torch.cuda.synchronize()
                if not (torch.allclose(score, ref, rtol=1e-4, atol=1e-4)
                        and torch.allclose(dq, ref_dq, rtol=1e-3, atol=1e-3)):
                    raise AssertionError(f'{who} disagrees with the plain '
                                         f'twin at C = {C}')
                row[f'{who}_max_abs_err'] = max(
                    float((score - ref).abs().max()),
                    float((dq - ref_dq).abs().max()))
            t = [_time_ms(f) for f in (prod, alt, alt, prod)]
            out[name] = dict(row, production_ms=t[::3], other_ms=t[1:3])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--source', action='append', default=[],
                    help='another build of the C entry (repeatable)')
    ap.add_argument('--ablate', nargs='+', default=[], choices=ABLATIONS)
    ap.add_argument('--classes', type=int, nargs='+', default=[5, 8])
    ap.add_argument('--out', default=str(_native._BUILD / 'ab_kernel.json'))
    args = ap.parse_args(argv)
    builds = {src: (src, True) for src in args.source}
    builds.update({name: (_ablated(name), False) for name in args.ablate})
    if not builds:
        ap.error('give --source or --ablate')
    res = run(builds, args.classes)
    res.update(card_info(torch.device('cuda')))
    write_result(res, args.out)
    print(json.dumps({'ab_kernel': res}), flush=True)


if __name__ == '__main__':
    main()
