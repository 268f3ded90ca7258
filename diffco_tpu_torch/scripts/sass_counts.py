"""Instruction counts per (configuration, support) pair of a compiled
one-pass FK kernel, read from its SASS.

    python3 -m diffco_tpu_torch.scripts.sass_counts \\
        [--source diffco_tpu_torch/csrc/chain_multi_score.cu] [--fp 24] \\
        [--out PATH]

Compiles the source with the flags of ``ops/_native.py`` into a cubin
(``nvcc -cubin``, so it needs the CUDA toolkit but no card), disassembles
it with ``cuobjdump -sass`` and takes the kernel instance for ``--fp``
components (of B4 or B5, the multi-class block's full one; of B1, B2 and
B3, ``csrc/dh_score.cu``, ``poly_score.cu`` and ``chain_score.cu``, the
production tensor-core kernel, whose HMMA instructions must be there:
the run fails without them; ``roofline_hmma`` holds every instance of B6
and B7 to the same). Every
backward branch closes a loop; for each innermost loop it prints the
opcode counts of its body. Two kinds of loop carry the per-pair work:

- a loop with MUFU.RSQ runs one pair per rsqrt, so its counts per pair
  are the body's divided by its MUFU.RSQ count (every kernel's support
  loop, and phase A of ``csrc/multi_score_block.cuh``);
- with ``--product-cols N`` the loop without MUFU.RSQ and the most FFMAs
  is a register-tiled product in which each thread does N FFMAs per
  support, ``ops/_native.py``'s ``MULTI_THREADS`` threads for
  ``MULTI_ROWS`` rows (phase B: 64 FFMAs per support, 256 threads for 128
  rows), so its counts per pair are the body's x (threads / rows) /
  (FFMAs / N).

In the tensor-core block (B1, B2, B3) a lane computes four pairs per
n-tile of its support loop (one rsqrt each; two n-tiles per iteration
where x~'s fragments stay in registers), so the per-pair counts are the warp's instructions per 32 pairs, as in the
one-pair-per-thread kernels, and ``hmma_per_128_pairs`` is 4 HMMA /
MUFU.RSQ of the loop body. The near-pair guard's direct difference is a
call out of the loop, rarely taken: its call sites' set-up is in the
body's static counts, the difference itself is not.

The per-pair sum covers one pass over the supports; a kernel that walks
them once per class tile (``csrc/chain_multi_score.cu`` before the
multi-class block: three passes at C = 5) pays it once per pass. Work
outside those loops (staging, the class table, FK, backward) is not in
the sum; the whole function's counts are printed beside it. Pass
``--product-cols 0`` for a kernel without a product loop. The result
goes to ``--out`` (default ``build/diffco_tpu_torch/sass_counts.json``)
and is printed as JSON with the toolkit's version.

    python3 -m diffco_tpu_torch.scripts.sass_counts \\
        --source diffco_tpu_torch/csrc/poly_score.cu --wide 4

reads a wide instance instead (``poly_score_wide_kernel<K>`` of B2,
``chain_wide_score_kernel<K>`` of the FK kernels), whose DMMA
instructions (the fp64 tensor cores' ``mma.sync``) must be there;
``wide_dmma`` holds every wide instance of the built libraries to the
same.

    python3 -m diffco_tpu_torch.scripts.sass_counts --against OTHER_DIR \\
        --source diffco_tpu_torch/csrc/dh_score.cu [--source ...]

compares each source's SASS, kernel by kernel and instruction by
instruction, with that of the file of the same name in OTHER_DIR (another
commit's ``csrc/``), and prints how many kernels are identical and the
instruction counts of those that differ.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from ..ops import _native

KEYS = ('LDS', 'FFMA', 'FADD', 'FMUL', 'MUFU.RSQ', 'HMMA', 'DMMA', 'STS',
        'total')
# the wide instances on csrc/wide_score_block.cuh (fp64 tensor cores)
WIDE_KERNELS = ('poly_score_wide_kernel', 'chain_wide_score_kernel')
# the kernels on the tensor-core block (csrc/tc_score_block.cuh)
TC_KERNELS = ('dh_score_tc_kernel', 'poly_score_tc_kernel',
              'chain_score_tc_kernel')
# the roofline path's kernels on B1's block: B6's three variants
# (csrc/dh_dual_score.cu) and B7's six rungs (csrc/dh_ablation.cu), of
# which only the fk_only rung (<0>) runs no product
ROOFLINE_TC_SOURCES = {'dh_dual_score': ('dh_dual_score_tc_kernel', 3),
                       'dh_ablation': ('dh_ablation_kernel', 6)}
ROOFLINE_NO_PRODUCT = 'dh_ablation_kernelILi0EE'


def _tool(name):
    return str(Path(_native._nvcc()).with_name(name))


def _opcode(text):
    """'LDS.128' for '@P0 LDS.128 R4, [R2+0x10] ;' (the predicate dropped,
    MUFU kept with its function, other modifiers dropped)."""
    words = text.replace('{', ' ').split()
    if words and words[0].startswith('@'):
        words = words[1:]
    if not words:
        return None
    op = words[0].rstrip(';')
    base = op.split('.')[0]
    return op if base == 'MUFU' else base


def parse_functions(sass):
    """{mangled name: [(address, opcode, branch target or None)]} from
    cuobjdump -sass (targets as addresses or as labels)."""
    funcs, cur, labels, pending = {}, None, {}, []
    for ln in sass.splitlines():
        m = re.search(r'Function : (\S+)', ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            labels, pending = {}, []
            continue
        m = re.match(r'\s*(\.L_x_\d+):', ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?);', ln)
        if m and cur is not None:
            addr, text = int(m.group(1), 16), m.group(2)
            for lb in pending:
                labels[lb] = addr
            pending = []
            op = _opcode(text)
            if not op:
                continue
            t = re.search(r'BRA\s+(?:`\(?(\.L_x_\d+)\)?|(0x[0-9a-f]+))',
                          text)
            target = None
            if op == 'BRA' and t:
                target = (labels.get(t.group(1), addr) if t.group(1)
                          else int(t.group(2), 16))
            cur.append((addr, op, target))
    return funcs


def innermost_loops(instrs):
    """[(start, end)] address ranges closed by a backward BRA and holding
    no other such range."""
    loops = [(t, a) for a, _, t in instrs if t is not None and t < a]
    return [(a, b) for a, b in loops
            if not any(a <= c and d <= b and (c, d) != (a, b)
                       for c, d in loops)]


def counts(instrs, lo=None, hi=None):
    out = dict.fromkeys(KEYS, 0)
    for addr, op, _ in instrs:
        if (lo is None or addr >= lo) and (hi is None or addr <= hi):
            out['total'] += 1
            if op in out:
                out[op] += 1
    return out


def run(source, fp, product_cols=None, wide=None):
    src = Path(source).resolve()
    rows, threads = _native.MULTI_ROWS, _native.MULTI_THREADS
    _native._BUILD.mkdir(parents=True, exist_ok=True)
    cubin = _native._BUILD / f'{src.stem}-{fp}-sass.cubin'
    flags = [f for f in _native._NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    ptxas = subprocess.run([_native._nvcc(), *flags, '-cubin', '-o',
                            str(cubin), str(src)], capture_output=True,
                           text=True, check=True)
    sass = subprocess.run([_tool('cuobjdump'), '-sass', str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    version = subprocess.run([_native._nvcc(), '--version'],
                             capture_output=True, text=True).stdout
    funcs = parse_functions(sass)
    if wide is not None:
        name = next((n for n in funcs if any(k in n for k in WIDE_KERNELS)
                     and f'ILi{wide}EE' in n), None)
        if name is None:
            raise RuntimeError(f'no wide instance for K = {wide} in {src}: '
                               f'{sorted(funcs)}')
        return _report(src, name, funcs[name], wide, product_cols, ptxas,
                       version, rows, threads)
    # a tensor-core kernel's production instance <FP, false> (B1, B2,
    # B3), a multi-class kernel's full instance, <FP, kInstFull, 0>
    # (csrc/multi_score_block.cuh), else the one instance for FP
    names = [n for n in funcs if ('_score_grad_kernel' in n
                                  or any(k in n for k in TC_KERNELS))
             and f'ILi{fp}E' in n]
    name = next((n for n in names if any(k in n for k in TC_KERNELS)
                 and f'ILi{fp}ELb0EE' in n),
                next((n for n in names if f'ILi{fp}ELi2ELi0EE' in n),
                     names[0] if names else None))
    if name is None:
        raise RuntimeError(f'no kernel instance for FP = {fp} in {src}: '
                           f'{sorted(funcs)}')
    return _report(src, name, funcs[name], fp, product_cols, ptxas, version,
                   rows, threads)


def _report(src, name, instrs, fp, product_cols, ptxas, version, rows,
            threads):
    """The counts of kernel ``name`` (module docstring); raises when a
    tensor-core kernel has no HMMA or a wide instance no DMMA."""
    loops = [dict(start=hex(lo), end=hex(hi), body=counts(instrs, lo, hi))
             for lo, hi in innermost_loops(instrs)]
    # the support loop: most rsqrts (an unrolled body, not its remainder)
    rsq = [lp for lp in loops if lp['body']['MUFU.RSQ']]
    chosen = []
    rsq_loop = None
    if rsq:
        lp = rsq_loop = max(rsq, key=lambda lp: lp['body']['MUFU.RSQ'])
        lp['role'] = 'pairs, one per MUFU.RSQ'
        chosen.append((lp, 1.0 / lp['body']['MUFU.RSQ']))
    prod = [lp for lp in loops if not lp['body']['MUFU.RSQ']
            and product_cols and lp['body']['FFMA'] >= product_cols]
    if prod:
        lp = max(prod, key=lambda lp: lp['body']['FFMA'])
        per_iter = lp['body']['FFMA'] / product_cols
        lp['role'] = (f'product, {per_iter:g} supports per iteration, '
                      f'{threads} threads for {rows} rows')
        chosen.append((lp, threads / rows / per_iter))
    per_pair = dict.fromkeys(KEYS, 0.0)
    for lp, scale in chosen:
        for k in KEYS:
            per_pair[k] += lp['body'][k] * scale
    tc = any(k in name for k in TC_KERNELS)
    if tc and not counts(instrs)['HMMA']:
        raise RuntimeError(f'{name}: no HMMA instruction in its SASS')
    if any(k in name for k in WIDE_KERNELS) and not counts(instrs)['DMMA']:
        raise RuntimeError(f'{name}: no DMMA instruction in its SASS')
    log = ptxas.stderr + ptxas.stdout
    regs = re.search(rf"entry function '{re.escape(name)}'.*?"
                     r'(\d+) bytes stack frame, (\d+) bytes spill stores.*?'
                     r'Used (\d+) registers', log, re.S)
    return dict(source=src.name, kernel=name, fp=fp,
                toolkit=version.strip().splitlines()[-1] if version else None,
                ptxas=(dict(stack_bytes=int(regs.group(1)),
                            spill_bytes=int(regs.group(2)),
                            registers=int(regs.group(3))) if regs else None),
                function=counts(instrs), loops=loops,
                per_pair_per_pass=per_pair,
                hmma_per_128_pairs=(4 * rsq_loop['body']['HMMA']
                                    / rsq_loop['body']['MUFU.RSQ']
                                    if tc and rsq else None))


def roofline_hmma():
    """{mangled kernel: HMMA count} of every instance of B6 and B7 in the
    libraries ``_native.build()`` made (their SASS by cuobjdump; needs the
    toolkit, no card). Raises unless each source has all its instances
    and each, B7's fk_only rung aside, has HMMA."""
    libs = _native.build()
    out = {}
    for stem, (kernel, n) in ROOFLINE_TC_SOURCES.items():
        sass = subprocess.run([_tool('cuobjdump'), '-sass', libs[stem]._name],
                              capture_output=True, text=True,
                              check=True).stdout
        found = {name: counts(instrs)['HMMA']
                 for name, instrs in parse_functions(sass).items()
                 if kernel in name}
        if len(found) != n:
            raise RuntimeError(f'{stem}: {len(found)} instances of {kernel} '
                               f'in its SASS, not {n}: {sorted(found)}')
        missing = [k for k, c in found.items()
                   if not c and ROOFLINE_NO_PRODUCT not in k]
        if missing:
            raise RuntimeError(f'no HMMA instruction in the SASS of '
                               f'{missing}')
        out.update(found)
    return out


# the sources that hold a wide instance, and how many: B2's at K = 3-6,
# the FK kernels' at K = 1-6
WIDE_SOURCES = {'poly_score': 4, 'chain_score': 6, 'chain_multi_score': 6,
                'dh_score': 6, 'dh_multi_score': 6}


def wide_dmma():
    """{source: {mangled wide instance: DMMA count}} of the libraries
    ``_native.build()`` made (their SASS by cuobjdump; needs the toolkit,
    no card). Raises unless each source has all its wide instances and
    each has DMMA: both products of the wide block on the fp64 tensor
    cores."""
    libs = _native.build()
    out = {}
    for stem, n in WIDE_SOURCES.items():
        sass = subprocess.run([_tool('cuobjdump'), '-sass', libs[stem]._name],
                              capture_output=True, text=True,
                              check=True).stdout
        found = out[stem] = {
            name: counts(instrs)['DMMA']
            for name, instrs in parse_functions(sass).items()
            if any(k in name for k in WIDE_KERNELS)}
        if len(found) != n:
            raise RuntimeError(f'{stem}: {len(found)} wide instances in its '
                               f'SASS, not {n}: {sorted(found)}')
        missing = [k for k, c in found.items() if not c]
        if missing:
            raise RuntimeError(f'no DMMA instruction in the SASS of '
                               f'{missing}')
    return out


# an anonymous namespace's name, which nvcc derives from the file and the
# build
_ANON = re.compile(r'\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}')


def _instructions(sass):
    """{kernel: [instruction text]} from cuobjdump -sass, anonymous
    namespaces' names replaced by 'ANON' in both."""
    funcs, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r'Function : (\S+)', ln)
        if m:
            cur = funcs.setdefault(_ANON.sub('ANON', m.group(1)), [])
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(.*?);', ln)
        if m and cur is not None:
            cur.append(_ANON.sub('ANON', m.group(1)))
    return funcs


def compare(sources, other_dir):
    """Each source's SASS against that of the file of the same name in
    ``other_dir`` (for example another commit's ``csrc/``, unpacked with
    ``git archive``), kernel by kernel and instruction by instruction; all
    the cubins build in parallel. Returns one dict a source: the kernels
    identical, those that differ (with both instruction counts) and those
    in one build only."""
    flags = [f for f in _native._NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    _native._BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in map(Path, sources):
        for tag, path in (('this', src),
                          ('other', Path(other_dir) / src.name)):
            cubin = _native._BUILD / f'compare-{tag}-{src.stem}.cubin'
            procs.append((src, tag, cubin, subprocess.Popen(
                [_native._nvcc(), *flags, '-cubin', '-o', str(cubin),
                 str(path)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    sass = {}
    for src, tag, cubin, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {tag} {src.name}:\n{log}')
        sass[src, tag] = _instructions(subprocess.run(
            [_tool('cuobjdump'), '-sass', str(cubin)], capture_output=True,
            text=True, check=True).stdout)
    out = []
    for src in map(Path, sources):
        this, other = sass[src, 'this'], sass[src, 'other']
        both = sorted(set(this) & set(other))
        out.append(dict(
            source=src.name,
            identical=[k for k in both if this[k] == other[k]],
            differ={k: (len(other[k]), len(this[k])) for k in both
                    if this[k] != other[k]},
            only=sorted(set(this) ^ set(other))))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--source', action='append',
                    help='a kernel source (repeatable; default B5)')
    ap.add_argument('--fp', type=int, default=24)
    ap.add_argument('--product-cols', type=int, default=64)
    ap.add_argument('--wide', type=int, metavar='K',
                    help='read the wide instance for K = ceil(F / 32)')
    ap.add_argument('--against', metavar='DIR',
                    help='compare each source\'s SASS with DIR/<its name> '
                         'instead of counting')
    ap.add_argument('--out', default=str(_native._BUILD / 'sass_counts.json'))
    args = ap.parse_args(argv)
    sources = args.source or [str(_native._CSRC / 'chain_multi_score.cu')]
    if args.against:
        res = compare(sources, args.against)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
        print(json.dumps({'sass_compare': [
            dict(source=r['source'], identical=len(r['identical']),
                 differ=list(r['differ'].values()), only=r['only'])
            for r in res]}))
        return
    res = [run(s, args.fp, args.product_cols, args.wide) for s in sources]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({'sass_counts': res}))


if __name__ == '__main__':
    main()
