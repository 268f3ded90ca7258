"""Build and bind the hand-written CUDA kernels (``diffco_tpu_torch/csrc``).

At first use each ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <src>.cu

The libraries go to ``build/diffco_tpu_torch/`` at the root of the
checkout, named by a hash of every source, header and flag, so an edit
rebuilds and an unchanged tree reuses the build. They are loaded with
ctypes. A missing ``nvcc`` or a failed build is an error: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..profiling import count, span

_CSRC = Path(__file__).resolve().parents[1] / 'csrc'
_BUILD = Path(__file__).resolve().parents[2] / 'build' / 'diffco_tpu_torch'
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

MAX_J = 8    # dh_chain.cuh kMaxJ
MAX_P = 16   # dh_chain.cuh kMaxP
MAX_F = 192  # poly_score.cu kWideMaxF (the tensor-core block up to 64)
MAX_M = 16   # chain_fk.cuh kMaxM (moving joints)
MAX_D = 16   # chain_fk.cuh kMaxD (dofs)
MAX_CP = 21  # chain_fk.cuh kMaxCP (control points)
# chain_fk.cuh kWideMaxM, kWideMaxD, kWideMaxCP: the wide instances of the
# FK kernels (chain_wide.cuh), which take the chains past the bounds above
# (a DH chain folded into chain form) up to F = 3P = MAX_F
WIDE_MAX_M = WIDE_MAX_D = WIDE_MAX_CP = 64
MAX_C = 8    # score_block.cuh kMaxC (classes of the multi-class kernels)
GREEDY_MAX_N = 16384   # greedy_train.cu kGreedyMaxN (the trainer's rows)

# csrc/multi_score_block.cuh's block (kMultiRows, kMultiThreads,
# kMultiChunk, kMultiCols, the register instance's kRegCols, kRegMaxFP) and the
# H100's per-SM limits, mirrored so that the CPU tests can hold every
# instance's launch plan to the card. A change to MultiSmem's layout or to
# the launch rule (multi_dispatch) is made here too; on the card
# test_chain_multi_plan_matches_the_card and
# test_dh_multi_plan_matches_the_card hold this copy to both kernels.
MULTI_ROWS, MULTI_THREADS, MULTI_CHUNK, MULTI_COLS = 128, 256, 32, 128
MULTI_REG_COLS, MULTI_REG_MAX_FP = 50, 24
MULTI_INSTANCES = ('register', 'narrow', 'full')   # kInstReg, ... order
MULTI_MIN_BLOCKS = 2           # __launch_bounds__(256, 2): <= 128 registers
SM_SHARED_BYTES = 233472       # 228 KB per SM
BLOCK_SHARED_MAX = 232448      # 227 KB per block
BLOCK_SHARED_RESERVED = 1024   # the runtime's own share of each block
SM_MAX_THREADS = 2048


def multi_plan(P: int, C: int) -> dict:
    """The launch plan of the multi-class block (csrc/multi_score_block.cuh)
    for P control points and C classes, as ``chain_multi_score_plan`` and
    ``dh_multi_score_plan`` give it on the card: the instance the launch
    rule picks, its classes per pass (the register instance is built for
    each C up to its capacity, which is reported), passes, dynamic shared
    bytes per block, and the blocks and warps per SM that the register
    bound and shared memory allow."""
    fp = (3 * P + 7) // 8 * 8
    full = min(MULTI_COLS // (fp + 1), MAX_C)
    narrow = min(MULTI_COLS // 2 // (fp + 1), MAX_C)
    reg = min(MULTI_REG_COLS // (fp + 1), MAX_C) * (fp <= MULTI_REG_MAX_FP)
    K, R = MULTI_CHUNK, MULTI_ROWS
    # points, partial scores, supports, weights, then the accumulator's
    # half-tile [64][129] over the class table and Rinv
    floats = (R * fp + MULTI_THREADS * full * 2 + 2 * K * fp
              + 2 * K * 2 * MAX_C + 64 * (MULTI_COLS + 1))
    instance, cg = next((name, n) for name, n in zip(
        MULTI_INSTANCES, (reg, narrow, full)) if C <= n or name == 'full')
    smem = 4 * floats
    blocks = min(MULTI_MIN_BLOCKS,
                 SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVED),
                 SM_MAX_THREADS // MULTI_THREADS)
    return dict(fp=fp, instance=instance, classes_per_pass=cg,
                passes=-(-C // cg), smem_bytes=smem, blocks_per_sm=blocks,
                warps_per_sm=blocks * MULTI_THREADS // 32)


# csrc/tc_score_block.cuh's block (kTcRows, kTcThreads, kTcChunk, two
# blocks per SM by its launch bound, kTcGuard), mirrored for the launch
# plans of its three kernels (B1, B2, B3) as dh_score_plan,
# poly_score_plan and chain_score_plan give them on the card
# (tests/test_torch_cuda.py holds each to the card); a change to TcSmem's
# layout is made here too.
TC_ROWS, TC_THREADS, TC_CHUNK, TC_MIN_BLOCKS = 128, 256, 32, 2
TC_GUARD = 1 / 64   # kTcGuard, the near-pair guard's threshold
# B1's widths whose product-2 running sums live in shared memory
# (csrc/dh_tc_rows.cuh kDhSums == kTcSumsShared; per-chunk sums in
# registers at the others)
DH_SHARED_SUMS_FP = (24,)
# B2's and B3's widths whose product-2 running sums live in shared
# memory (csrc/poly_score.cu kPolySums, csrc/chain_score.cu kChainSums ==
# kTcSumsShared; in registers at the others)
POLY_SHARED_SUMS_FP = (56, 64)
CHAIN_SHARED_SUMS_FP = (64,)


def _run_floats(fp: int) -> int:
    """``TcSmem<FP>::kRunFloats``: 4 floats per thread per column tile
    of product 2."""
    return 4 * (fp // 8 + 1) * TC_THREADS


def _tc_block_floats(fp: int) -> int:
    """``TcSmem<FP>::kFloats``: the block's shared floats, the larger of
    its layout in the support loop and after it."""
    K, R = TC_CHUNK, TC_ROWS
    area = fp + 2 * R + R * (fp + 1)       # centre, |x~|^2, x~ rows
    # raw double buffer, weights, both B fragments, (|s~|^2, w)
    loop = area + 2 * K * fp + 2 * K + 2 * K * fp + 2 * K * (fp + 8) \
        + 2 * K
    sums = area + R * (fp + 9) + R         # after the loop: sums, scores
    return max(loop, sums)


def _tc_plan(fp: int, row_floats: int, extra_floats: int = 0) -> dict:
    """The plan of a kernel on the tensor-core block that adds
    ``row_floats`` shared floats per row and ``extra_floats`` per block
    after ``TcSmem<FP>``: dynamic shared bytes per block, and the blocks
    and warps per SM that the register bound and shared memory allow."""
    smem = 4 * (_tc_block_floats(fp) + TC_ROWS * row_floats + extra_floats)
    blocks = min(TC_MIN_BLOCKS,
                 SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVED),
                 SM_MAX_THREADS // TC_THREADS)
    return dict(fp=fp, smem_bytes=smem, blocks_per_sm=blocks,
                warps_per_sm=blocks * TC_THREADS // 32,
                threads=TC_THREADS, rows=TC_ROWS)


def dh_tc_plan(P: int) -> dict:
    """B1's launch plan (``csrc/dh_score.cu``) for P control points: the
    block's shared memory, each row's joint axes and origins
    (``DhSmem<FP>``, csrc/dh_tc_rows.cuh, 6 kMaxJ + 1 floats a row) and, at
    ``DH_SHARED_SUMS_FP``, product 2's running sums (``TcSmem<FP>::
    kRunFloats``: 4 floats per thread per column tile)."""
    fp = (3 * P + 7) // 8 * 8
    run = _run_floats(fp) if fp in DH_SHARED_SUMS_FP else 0
    return _tc_plan(fp, 6 * MAX_J + 1, run)


# csrc/poly_score.cu's fp64 instance of B2 at F <= F64_MAX_F (kF64MaxF,
# kF64Rows threads and rows a block, kF64Chunk supports of F64_MAX_F + 1
# floats in shared memory, __launch_bounds__ minimum kF64MinBlocks)
F64_MAX_F, F64_ROWS, F64_CHUNK, F64_MIN_BLOCKS = 8, 256, 256, 3
# its wide instance at TC_MAX_F < F <= MAX_F (poly_score_wide_kernel<K>,
# K = ceil(F / 32), on csrc/wide_score_block.cuh: kWideRows rows a block
# in kWideRowTiles row tiles of 16, kWideSplit<K> warps a row tile,
# kWideChunk supports a chunk in a ring of kWideStages, kWideMinBlocks<K>
# in the launch bound) and the FK kernels' wide instance on the same block
# (csrc/chain_wide.cuh)
TC_MAX_F = 64
WIDE_CHUNK, WIDE_ROW_TILES = 32, 4
WIDE_ROWS = 16 * WIDE_ROW_TILES
WIDE_STAGES = WIDE_ROWS // WIDE_CHUNK


def wide_split(K: int) -> int:
    """``kWideSplit<K>``: warps a row tile, one up to K = 4, two above."""
    return 1 if K <= 4 else 2


def wide_threads(K: int) -> int:
    """``kWideThreads<K>``: the wide block's threads."""
    return 32 * WIDE_ROW_TILES * wide_split(K)


def wide_min_blocks(K: int) -> int:
    """``kWideMinBlocks<K>``: the launch bound's blocks per SM, 16 warps
    per SM at K = 1, 12 at K = 2, 8 above, at least one block."""
    warps_per_sm = {1: 16, 2: 12}.get(K, 8)
    return max(1, warps_per_sm // (wide_threads(K) // 32))


def wide_stride(F: int) -> int:
    """``wide_stride(F)``: the row stride of s~ and the sums (doubles)
    and of the rows' points (floats), 32 ceil(F / 32) + 4."""
    return -(-F // 32) * 32 + 4


def wide_prep_doubles(S: int, F: int, C: int) -> int:
    """``wide_prep_doubles``: the wide block's prologue buffer, every wide
    entry's ``prep``: the centre, s~ [Sp, stride] and per weight column
    (|s~|^2, w) [Sp, 2], Sp = S padded to whole chunks."""
    sp = -(-S // WIDE_CHUNK) * WIDE_CHUNK
    return wide_stride(F) * (1 + sp) + 2 * sp * C


def wide_smem_doubles(K: int) -> int:
    """``WideSmem<K>::kEnd``: the wide block's shared doubles: the centre
    and the row stride 32 K + 4, |x~|^2 and the scores [rows], the rows'
    fp32 points [rows][stride], then the ring: s~ [stages][chunk][stride]
    (the sums [rows][stride] after the loop) and (|s~|^2, w)
    [stages][chunk]."""
    stride = 32 * K + 4
    return (stride + 2 * WIDE_ROWS + WIDE_ROWS * stride // 2
            + WIDE_STAGES * WIDE_CHUNK * (stride + 2))


def _wide_plan(K: int, smem: int) -> dict:
    blocks = min(wide_min_blocks(K),
                 SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVED))
    return dict(fp=32 * K, smem_bytes=smem, blocks_per_sm=blocks,
                warps_per_sm=blocks * wide_threads(K) // 32,
                threads=wide_threads(K), rows=WIDE_ROWS)


def poly_tc_plan(F: int) -> dict:
    """B2's launch plan (``csrc/poly_score.cu``) for F components: the
    tensor-core block's shared memory alone (F64_MAX_F < F <= TC_MAX_F),
    or the fp64 or the wide instance's chunk, with the blocks per SM
    their launch bounds guarantee (their registers, which only the build
    knows, may allow more: ``poly_plan_holds``). At
    ``POLY_SHARED_SUMS_FP`` the block adds product 2's running sums
    (``PolySmem<FP>``)."""
    if F <= F64_MAX_F:
        return dict(fp=8, smem_bytes=4 * F64_CHUNK * (F64_MAX_F + 1),
                    blocks_per_sm=F64_MIN_BLOCKS,
                    warps_per_sm=F64_MIN_BLOCKS * F64_ROWS // 32,
                    threads=F64_ROWS, rows=F64_ROWS)
    if F > TC_MAX_F:
        K = -(-F // 32)
        return _wide_plan(K, 8 * wide_smem_doubles(K))
    fp = (F + 7) // 8 * 8
    return _tc_plan(fp, 0, _run_floats(fp) if fp in POLY_SHARED_SUMS_FP
                    else 0)


def poly_plan_holds(card: dict, F: int) -> bool:
    """B2's plan as the card gives it (``poly_score_plan_on_card``) is
    ``poly_tc_plan``'s: equal for the tensor-core and the wide instances;
    for the fp64 instance the same shared bytes, threads and rows, and at
    least the blocks per SM of its launch bound."""
    plan = poly_tc_plan(F)
    if F > F64_MAX_F:
        return card == plan
    return (all(card[k] == plan[k]
                for k in ('fp', 'smem_bytes', 'threads', 'rows'))
            and card['blocks_per_sm'] >= plan['blocks_per_sm'])


def chain_tc_plan(P: int, M: int) -> dict:
    """B3's launch plan (``csrc/chain_score.cu``) for P control points and
    M moving joints: the block's shared memory, at
    ``CHAIN_SHARED_SUMS_FP`` product 2's running sums, and each row's
    joint axes and origins (``ChainSmem<FP>``, 6 M + 1 floats a row)."""
    fp = (3 * P + 7) // 8 * 8
    return _tc_plan(fp, 6 * M + 1, _run_floats(fp)
                    if fp in CHAIN_SHARED_SUMS_FP else 0)


def chain_wide_plan(P: int, M: int) -> dict:
    """The wide FK instances' launch plan (``csrc/chain_wide.cuh``,
    K = ceil(3P / 32)) for P control points and M moving joints: the wide
    block's shared memory (``wide_smem_doubles``; the backward's gradients
    go over its sums), the spec (``ChainSpecWide``, in whole 16-byte
    words), the points' ancestor masks (2 WIDE_MAX_CP floats) and each
    warp's joints' values (WIDE_MAX_M + 1 floats, in whole 16-byte words),
    whatever M (the joints' axes and origins go to a scratch in device
    memory, ``wide_scratch_floats``); ``wide_threads(K)`` threads and
    WIDE_ROWS rows, and the blocks per SM that the launch bound
    (``wide_min_blocks``) and shared memory allow."""
    K = -(-3 * P // 32)
    spec = (ctypes.sizeof(ChainSpecWide) // 4 + 3) // 4 * 4
    jv = (WIDE_MAX_M + 1 + 3) // 4 * 4
    return _wide_plan(K, 8 * wide_smem_doubles(K) + 4 * (
        spec + 2 * WIDE_MAX_CP + wide_threads(K) // 32 * jv))


# the libraries with a wide instance, each exporting the prologue
WIDE_LIBS = ('poly_score', 'dh_score', 'chain_score', 'dh_multi_score',
             'chain_multi_score')


def wide_prep(lib: str, s, W, F: int, C: int, out, stream):
    """Launch the wide block's prologue (``csrc/wide_launch.cuh``'s
    ``wide_prep`` of ``lib``, counted in ``launches.wide_prep``) on
    ``stream``: supports s [S, F] and weight columns W (the C columns of
    [S, C], or [S] at C = 1) ready for the tensor cores in ``out`` (a
    float32 tensor of ``2 * wide_prep_doubles(S, F, C)``), the wide
    entries' ``prep``."""
    launch(lib, 'wide_prep', s.data_ptr(), W.data_ptr(), s.shape[0], F, C,
           out.data_ptr(), stream)


def wide_scratch_floats(B: int, M: int) -> int:
    """The wide FK instance's scratch (its C entries' ``zo``): each
    configuration's moving joints' world axes and origins, B M 6
    floats."""
    return B * M * 6


def chain_wide_plan_holds(card: dict, P: int, M: int) -> bool:
    """The wide FK instance's plan as the card gives it
    (``chain_wide_plan_on_card``) is ``chain_wide_plan``'s: the same shared
    bytes, threads and rows, and at least its blocks per SM (equal where
    shared memory bounds them; a small chain's registers may allow
    more)."""
    plan = chain_wide_plan(P, M)
    return (all(card[k] == plan[k]
                for k in ('fp', 'smem_bytes', 'threads', 'rows'))
            and card['blocks_per_sm'] >= plan['blocks_per_sm'])


class DHSpec(ctypes.Structure):
    """Mirror of ``struct DHSpec`` in csrc/dh_chain.cuh."""
    _fields_ = [('J', ctypes.c_int),
                ('P', ctypes.c_int),
                ('dh', (ctypes.c_float * 5) * MAX_J),
                ('frame', ctypes.c_int * MAX_P),
                ('off', (ctypes.c_float * 3) * MAX_P),
                ('base_r', ctypes.c_float * 9),
                ('base_t', ctypes.c_float * 3)]


def dh_spec(st) -> DHSpec | None:
    """The by-value ``DHSpec`` of a DH chain, ``st`` a
    ``robots.fk_jvp.DHStatics``; None past the kernels' 1 to MAX_J joints
    and 1 to MAX_P control points."""
    J, P = len(st.dh_const), len(st.point_specs)
    if not (1 <= J <= MAX_J and 1 <= P <= MAX_P):
        return None
    c = DHSpec()
    c.J, c.P = J, P
    for j, row in enumerate(st.dh_const):
        c.dh[j][:] = row
    for k, (fi, off) in enumerate(st.point_specs):
        c.frame[k] = fi
        c.off[k][:] = off
    c.base_r[:] = st.base_rot
    c.base_t[:] = st.base_trans
    return c


def _chain_spec_fields(mm, mcp):
    return [('M', ctypes.c_int),
            ('P', ctypes.c_int),
            ('D', ctypes.c_int),
            ('mparent', ctypes.c_int * mm),
            ('jtype', ctypes.c_int * mm),
            ('dof', ctypes.c_int * mm),
            ('mult', ctypes.c_float * mm),
            ('off', ctypes.c_float * mm),
            ('axis', (ctypes.c_float * 3) * mm),
            ('pre_r', (ctypes.c_float * 9) * mm),
            ('pre_t', (ctypes.c_float * 3) * mm),
            ('pframe', ctypes.c_int * mcp),
            ('poff', (ctypes.c_float * 3) * mcp)]


class ChainSpec(ctypes.Structure):
    """Mirror of ``ChainSpec`` (``ChainSpecT<kMaxM, kMaxD, kMaxCP>``) in
    csrc/chain_fk.cuh."""
    _fields_ = _chain_spec_fields(MAX_M, MAX_CP)


class ChainSpecWide(ctypes.Structure):
    """Mirror of ``ChainSpecWide`` (``ChainSpecT<kWideMaxM, kWideMaxD,
    kWideMaxCP>``) in csrc/chain_fk.cuh: the wide instances' chain, passed
    as a device copy."""
    _fields_ = _chain_spec_fields(WIDE_MAX_M, WIDE_MAX_CP)


_libs = {}
build_log = ''        # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    path = shutil.which('nvcc')
    if path is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        path = '/usr/local/cuda/bin/nvcc'
    if path is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'diffco_tpu_torch cannot be built')
    return path


def _source_hash() -> str:
    h = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in ('.cu', '.cuh'):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile every ``csrc/*.cu`` not yet built for this source hash (one
    nvcc per source, in parallel) and load the libraries. Idempotent; the
    compile or load is the kept span ``diffco.native.build``."""
    if _libs:
        return _libs
    with span('diffco.native.build', keep=True):
        return _build()


def _build():
    global build_log
    tag = _source_hash()
    _BUILD.mkdir(parents=True, exist_ok=True)
    sources = sorted(_CSRC.glob('*.cu'))
    targets = {src.stem: _BUILD / f'{src.stem}-{tag}.so' for src in sources}
    procs, logs = [], []
    for src in sources:
        out = targets[src.stem]
        if out.exists():   # built before: its nvcc output beside it
            log = out.with_suffix('.log')
            logs.append(log.read_text() if log.exists() else
                        f'== {src.name}: built before, no log\n')
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *_NVCC_FLAGS, '-o', str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(f'== {src.name}\n{text}')
        if proc.returncode != 0:
            failed.append(src.name)
        else:
            out.with_suffix('.log').write_text(logs[-1])
            os.replace(tmp, out)
    build_log = '\n'.join(logs)
    if failed:
        raise RuntimeError(f'nvcc failed for {failed}:\n{build_log}')
    for name, path in targets.items():
        _libs[name] = ctypes.CDLL(str(path))
    _bind(_libs)
    return _libs


def _bind(libs):
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    fn = libs['poly_score'].poly_score_grad
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint, ptr]
    fn.restype = cint
    fn = libs['dh_score'].dh_score_grad
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint,
                   ctypes.POINTER(DHSpec), ptr]
    fn.restype = cint
    # B1's measurement build (the near-pair guard's count) and its plan
    fn = libs['dh_score'].dh_score_grad_guard
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, ctypes.c_float, ptr,
                   ctypes.POINTER(DHSpec), ptr]
    fn.restype = cint
    fn = libs['dh_score'].dh_score_plan
    fn.argtypes = [cint, ctypes.POINTER(cint)]
    fn.restype = cint
    fn = libs['chain_score'].chain_score_grad
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint,
                   ctypes.POINTER(ChainSpec), ptr]
    fn.restype = cint
    # B2's and B3's measurement builds (the guard's count) and plans
    fn = libs['poly_score'].poly_score_grad_guard
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint, ctypes.c_float,
                   ptr, ptr]
    fn.restype = cint
    fn = libs['poly_score'].poly_score_plan
    fn.argtypes = [cint, ctypes.POINTER(cint)]
    fn.restype = cint
    fn = libs['chain_score'].chain_score_grad_guard
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, ctypes.c_float, ptr,
                   ctypes.POINTER(ChainSpec), ptr]
    fn.restype = cint
    fn = libs['chain_score'].chain_score_plan
    fn.argtypes = [cint, cint, ctypes.POINTER(cint)]
    fn.restype = cint
    # the wide instances, each after the wide block's prologue: x or q,
    # the prologue's buffer, score, dx or dq, B, S, then F (B2) or [C],
    # host spec, device copy, the joints' axes and origins' scratch
    # (csrc/chain_wide.cuh), the stream
    wide = ctypes.POINTER(ChainSpecWide)
    for lib, name, n_int in (('dh_score', 'dh_score_grad', 2),
                             ('chain_score', 'chain_score_grad', 2),
                             ('dh_multi_score', 'dh_multi_score_grad', 3),
                             ('chain_multi_score', 'chain_multi_score_grad',
                              3)):
        fn = getattr(libs[lib], f'{name}_wide')
        fn.argtypes = [ptr] * 4 + [cint] * n_int + [wide, ptr, ptr, ptr]
        fn.restype = cint
    fn = libs['poly_score'].poly_score_grad_wide
    fn.argtypes = [ptr] * 4 + [cint] * 3 + [ptr]
    fn.restype = cint
    # the wide block's prologue, which each source with a wide instance
    # exports: s, W, S, F, C, the buffer, the stream
    for lib in WIDE_LIBS:
        fn = libs[lib].wide_prep
        fn.argtypes = [ptr, ptr, cint, cint, cint, ptr, ptr]
        fn.restype = cint
    fn = libs['chain_score'].chain_score_wide_plan
    fn.argtypes = [cint, cint, ctypes.POINTER(cint)]
    fn.restype = cint
    fn = libs['dh_multi_score'].dh_multi_score_grad
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint,
                   ctypes.POINTER(DHSpec), ptr]
    fn.restype = cint
    fn = libs['chain_multi_score'].chain_multi_score_grad
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint,
                   ctypes.POINTER(ChainSpec), ptr]
    fn.restype = cint
    for lib in ('dh_multi_score', 'chain_multi_score'):
        fn = getattr(libs[lib], f'{lib}_plan')
        fn.argtypes = [cint, cint, ctypes.POINTER(cint)]
        fn.restype = cint
    # the roofline path (diffco_tpu_torch/scripts): B1 at other block
    # sizes, the B7 ablations and the B6 dual half-tile kernel
    fn = libs['dh_score'].dh_score_grad_threads
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint,
                   ctypes.POINTER(DHSpec), ptr]
    fn.restype = cint
    fn = libs['dh_ablation'].dh_ablation
    fn.argtypes = [ptr, ptr, ptr, ptr, cint, cint, cint,
                   ctypes.POINTER(DHSpec), ptr]
    fn.restype = cint
    fn = libs['dh_dual_score'].dh_dual_score_grad
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint,
                   ctypes.POINTER(DHSpec), ptr]
    fn.restype = cint
    # the FK and its VJP (robots/fk_jvp.py::_DHFkine): q's row stride
    fn = libs['dh_fk'].dh_fk
    fn.argtypes = [ptr, ctypes.c_longlong, ptr, cint, ctypes.POINTER(DHSpec),
                   ptr]
    fn.restype = cint
    fn = libs['dh_fk'].dh_fk_vjp
    fn.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, cint,
                   ctypes.POINTER(DHSpec), ptr]
    fn.restype = cint
    # the greedy trainer (perceptron.py::_train_kernel): K, y, the warm
    # start's gains and hypothesis, valid (each optional one may be null),
    # N, C, beta, max_iteration, gains, hyp, iters, stream
    fn = libs['greedy_train'].greedy_train
    fn.argtypes = [ptr] * 5 + [cint, cint, ctypes.c_float, cint] + [ptr] * 4
    fn.restype = cint


def _multi_plan_on_card(lib: str, P: int, C: int) -> dict:
    out = (ctypes.c_int * 5)()
    entry = f'{lib}_plan'
    raise_on_error(entry, getattr(build()[lib], entry)(P, C, out))
    return dict(instance=MULTI_INSTANCES[out[4]], classes_per_pass=out[0],
                passes=out[1], smem_bytes=out[2], blocks_per_sm=out[3],
                warps_per_sm=out[3] * MULTI_THREADS // 32)


def chain_multi_plan_on_card(P: int, C: int) -> dict:
    """``multi_plan``'s numbers as B5's build and the card's occupancy
    calculator give them (needs the card)."""
    return _multi_plan_on_card('chain_multi_score', P, C)


def dh_multi_plan_on_card(P: int, C: int) -> dict:
    """``multi_plan``'s numbers as B4's build and the card's occupancy
    calculator give them (needs the card)."""
    return _multi_plan_on_card('dh_multi_score', P, C)


def _tc_plan_on_card(lib: str, entry: str, fp: int, *args) -> dict:
    out = (ctypes.c_int * 4)()
    raise_on_error(entry, getattr(build()[lib], entry)(*args, out))
    return dict(fp=fp, smem_bytes=out[0], blocks_per_sm=out[1],
                warps_per_sm=out[1] * out[2] // 32, threads=out[2],
                rows=out[3])


def dh_score_plan_on_card(P: int) -> dict:
    """``dh_tc_plan``'s numbers as B1's build and the card's occupancy
    calculator give them (needs the card)."""
    return _tc_plan_on_card('dh_score', 'dh_score_plan',
                            (3 * P + 7) // 8 * 8, P)


def poly_score_plan_on_card(F: int) -> dict:
    """``poly_tc_plan``'s numbers as B2's build and the card's occupancy
    calculator give them (needs the card)."""
    return _tc_plan_on_card('poly_score', 'poly_score_plan',
                            poly_tc_plan(F)['fp'], F)


def chain_score_plan_on_card(P: int, M: int) -> dict:
    """``chain_tc_plan``'s numbers as B3's build and the card's occupancy
    calculator give them (needs the card)."""
    return _tc_plan_on_card('chain_score', 'chain_score_plan',
                            (3 * P + 7) // 8 * 8, P, M)


def chain_wide_plan_on_card(P: int, M: int) -> dict:
    """``chain_wide_plan``'s numbers as B3's build and the card's occupancy
    calculator give them (needs the card)."""
    return _tc_plan_on_card('chain_score', 'chain_score_wide_plan',
                            chain_wide_plan(P, M)['fp'], P, M)


def check_cuda_inputs(name, *tensors):
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device (what the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != 'cuda':
            raise ValueError(f'{name}: all inputs must be on one CUDA device')
        if t.dtype != torch.float32:
            raise ValueError(f'{name}: inputs must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')


def raise_on_error(name, rc: int):
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError {rc}')


def launch(lib: str, entry: str, *args, kernel: str | None = None):
    """Launch a kernel: call the C entry ``entry`` of the library ``lib``
    (looked up in ``build()`` at each call) with ``args``, raise on a
    nonzero return code, else count one in the counter
    ``launches.<kernel>`` (default ``launches.<entry>``). Every
    production launch of the package goes through here."""
    raise_on_error(entry, getattr(build()[lib], entry)(*args))
    count(f'launches.{kernel or entry}')
