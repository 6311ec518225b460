#!/usr/bin/env python3
"""Design steps of the decode-attention kernels (TPU kernels 3-4), timed
on one card.

    python3 tools/decode_steps.py [--parent CHECKOUT] [--rounds 2]

Each variant is ``skypilot_tpu_torch/csrc/decode_attention.cu`` with a
few lines replaced, or bf16 queries sent to the CUDA-core kernel
(``VARIANTS``: one design step taken out, or a diagnostic: the loads
alone, the compute alone, no epilogue, an empty launch of the same
grid); all are compiled at once by ``nvcc`` into the
git-ignored ``build/decode_steps/`` and bound through the port's own
wrapper (``ops/decode_attention.py``), so every variant runs the grid,
split count and shared memory of the real call. Split counts are timed
through the wrapper with its split rule replaced by a constant. With
``--parent`` the decode attention of another checkout (e.g. the parent
commit, unpacked with ``git archive`` under ``build/``) is timed
through its own package in a child process, before and after this
checkout's variants. The real kernel and every variant that is not a
diagnostic are first held to the plain version at every shape. Times
are ``chip_smoke.py:time_ms`` medians (L2 flushed before each
launch), in ``--rounds`` rounds, at llama3-8b heads (KVH=8, G=4,
D=128): B=8 mixed lengths 1..2048 at T=2048 with Q=1 and Q=5, the batch
engine's B=4 T=288, and B=128 mixed; bf16 and int8 caches. Prints one
``[steps]`` line per (variant, shape) and a JSON line of all times.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Text replacements on csrc/decode_attention.cu, each (old, new); every
# `old` must occur in the source.
_ONE_STAGE = [
    ('namespace {\n\n// A CTA',
     'namespace {\n\n__host__ __device__ constexpr int one_stage(int, int) {\n'
     '  return 1;\n}\n\n'
     '// A CTA'),
    ('mma_stages(', 'one_stage('), ('simt_stages(', 'one_stage(')]
_I2F = [('namespace {\n\n// A CTA', '''namespace {

template <int D>
__device__ __forceinline__ void widen_i2f(bf16* dst, const int8_t* src,
                                          int lane) {
  constexpr int kVecPerRow = D / 16;
#pragma unroll
  for (int c = 0; c < kMmaTile * kVecPerRow / 32; ++c) {
    const int v = c * 32 + lane;
    const int row = v / kVecPerRow;
    const int col = (v % kVecPerRow) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * (D + 16) +
                                                      col);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = pack_floats(static_cast<float>(e[2 * i]),
                         static_cast<float>(e[2 * i + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + row * (D + 8) + col);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// A CTA'''), ('widen<D>(', 'widen_i2f<D>(')]
_LOADS_ONLY = [('    const bf16* tk;\n    const bf16* tv;\n',
                '    __syncwarp();\n    continue;\n    const bf16* tk;\n'
                '    const bf16* tv;\n')]
_COMPUTE_ONLY = [
    ('    cp_async16(sk + row * pitch + col, k_cache + off, in);\n'
     '    cp_async16(sv + row * pitch + col, v_cache + off, in);\n', ''),
    ('    cp_async4(sks + lane, k_scale + so, in);\n'
     '    cp_async4(svs + lane, v_scale + so, in);\n', '')]
_NO_EPILOGUE = [('    idle_split(sp.active);\n', ''),
                ('  finish<bf16, D>(', '  if (false) finish<bf16, D>(')]
_EMPTY = [('  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;\n'
           '  constexpr int kStages = mma_stages',
           '  return;\n'
           '  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;\n'
           '  constexpr int kStages = mma_stages')]

_PARALLEL_MERGE = [('namespace {\n\n// A CTA', '''namespace {

// finish() with rank 0 loading every rank's (max, sum, acc) of an element
// at once (a fixed 4-way unrolled loop) instead of merging rank by rank.
template <typename TQ, int D>
__device__ __forceinline__ void finish_par(unsigned char* smem, int slabs,
                                           int per_warp, int off_acc,
                                           int off_m, int off_l, float* s_row,
                                           int qg, int bh, int active,
                                           TQ* __restrict__ out) {
  const int nw = blockDim.x / 32;
  auto warp_f = [&](int w, int off) {
    return reinterpret_cast<float*>(smem + slabs + w * per_warp + off);
  };
  __syncthreads();
  for (int r = threadIdx.x; r < qg; r += blockDim.x) {
    float m = kNegInf;
    for (int w = 0; w < nw; ++w) m = fmaxf(m, warp_f(w, off_m)[r]);
    float l = 0.f;
    for (int w = 0; w < nw; ++w)
      l += warp_f(w, off_l)[r] * exp2f(warp_f(w, off_m)[r] - m);
    s_row[r] = m;
    s_row[qg + r] = l;
  }
  __syncthreads();
  TQ* out_bh = out + static_cast<size_t>(bh) * qg * D;
  float* acc = warp_f(0, off_acc);
  for (int i = threadIdx.x; i < qg * D; i += blockDim.x) {
    const int r = i / D;
    float a = 0.f;
    for (int w = 0; w < nw; ++w)
      a += warp_f(w, off_acc)[i] * exp2f(warp_f(w, off_m)[r] - s_row[r]);
    if (active == 1)
      out_bh[i] = from_float<TQ>(a / fmaxf(s_row[qg + r], 1e-30f));
    else
      acc[i] = a;
  }
  if (active == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const float* rows[4];
    const float* accs[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      rows[s] = cluster.map_shared_rank(s_row, s < active ? s : 0);
      accs[s] = cluster.map_shared_rank(acc, s < active ? s : 0);
    }
    for (int i = threadIdx.x; i < qg * D; i += blockDim.x) {
      const int r = i / D;
      float ms[4], ls[4], as[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ms[s] = rows[s][r];
        ls[s] = rows[s][qg + r];
        as[s] = accs[s][i];
      }
      float m = ms[0];
#pragma unroll
      for (int s = 1; s < 4; ++s)
        if (s < active) m = fmaxf(m, ms[s]);
      float l = 0.f;
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float w = s < active ? exp2f(ms[s] - m) : 0.f;
        l += ls[s] * w;
        a += as[s] * w;
      }
      out_bh[i] = from_float<TQ>(a / fmaxf(l, 1e-30f));
    }
  }
  cluster.sync();
}

// A CTA'''), ('  finish<bf16, D>(', '  finish_par<bf16, D>(')]

# name -> (replacements, split count or None for the wrapper's rule,
# True to send bf16 queries to the CUDA-core kernel too)
VARIANTS = {
    'final': ([], None, False),
    # cumulative: (a) CUDA cores, one stage; (b) + the ring; (c) + tensor
    # cores with I2F widening; final = (c) + byte_perm widening
    '(a) CUDA cores, one stage': (_ONE_STAGE, None, True),
    '(b) CUDA cores, ring': ([], None, True),
    '(c) tensor cores, I2F widening': (_I2F, None, False),
    # one kept step taken out of the final design
    'final, one stage': (_ONE_STAGE, None, False),
    'final, 1 split': ([], 1, False),
    'final, 2 splits': ([], 2, False),
    'final, 3 splits': ([], 3, False),
    # candidate
    'final, parallel merge': (_PARALLEL_MERGE, None, False),
    # diagnostics
    'final, loads only': (_LOADS_ONLY, None, False),
    'final, compute only': (_COMPUTE_ONLY, None, False),
    'final, no epilogue': (_NO_EPILOGUE, None, False),
    'empty launch': (_EMPTY, None, False),
}


# Variants that compute something else on purpose (timing only).
DIAGNOSTICS = {'final, loads only', 'final, compute only',
               'final, no epilogue', 'empty launch'}


def variant_source(replacements) -> str:
    with open(os.path.join(ROOT, 'skypilot_tpu_torch', 'csrc',
                           'decode_attention.cu')) as f:
        src = f.read()
    for old, new in replacements:
        if old not in src:
            raise ValueError(f'variant text not found: {old[:60]!r}')
        src = src.replace(old, new)
    return src


def build_variants(names):
    """Compile every variant of ``names`` that changes the source, all
    at once; returns {name: library path or None (the checkout's own)}."""
    from skypilot_tpu_torch import _build
    nvcc = _build.find_nvcc()
    out_dir = os.path.join(ROOT, 'build', 'decode_steps')
    os.makedirs(out_dir, exist_ok=True)
    libs, procs = {}, []
    for i, name in enumerate(names):
        repl = VARIANTS[name][0]
        if not repl:
            libs[name] = None
            continue
        src = os.path.join(out_dir, f'v{i}.cu')
        with open(src, 'w') as f:
            f.write(variant_source(repl))
        lib = os.path.join(out_dir, f'libv{i}.so')
        cmd = ([nvcc] + _build.NVCC_FLAGS +
               ['-I', _build.CSRC_DIR, '-o', lib, src])
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        libs[name] = lib
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{out}')
    return libs


def time_all(torch, runs, flush):
    """{label: ms} of ``runs`` ({label: call}), one round."""
    import chip_smoke
    return {label: chip_smoke.time_ms(torch, call, flush)
            for label, call in runs.items()}


def cases(torch):
    import chip_smoke
    out = {}
    for cache in ('bf16', 'int8'):
        for label, shape in chip_smoke.decode_timed_shapes(
                dict(kvh=8, g=4, d=128)).items():
            out[f'{cache} {label}'] = chip_smoke.decode_case(
                torch, cache=cache, seed=400, **shape)
    return out


def time_checkout(rounds: int) -> dict:
    """Times of this process's ``skypilot_tpu_torch`` decode attention
    (whatever checkout it was imported from)."""
    import torch
    import chip_smoke
    from skypilot_tpu_torch.ops import decode_attention as da
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device='cuda')
    cs = cases(torch)
    runs = {k: (lambda c=c: chip_smoke.run_decode(da, c))
            for k, c in cs.items()}
    times = [time_all(torch, runs, flush) for _ in range(rounds)]
    return {k: [t[k] for t in times] for k in runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='another checkout to time first and '
                    'last (its own package, in a child process)')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--only', nargs='*', help='variant names to time '
                    '(default: all)')
    ap.add_argument('--checkout-only', action='store_true',
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # chip_smoke.py always from this checkout; the package from the
    # checkout under test (PYTHONPATH in the child, this one otherwise)
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    sys.modules['chip_smoke'] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules['chip_smoke'])
    sys.path.insert(0, os.environ.get('PYTHONPATH') if args.checkout_only
                    else ROOT)
    if args.checkout_only:
        print(json.dumps(time_checkout(args.rounds)))
        return 0
    import torch
    import chip_smoke
    from skypilot_tpu_torch import _build
    from skypilot_tpu_torch.ops import decode_attention as da

    def parent_times():
        env = dict(os.environ, PYTHONPATH=os.path.abspath(args.parent))
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--checkout-only',
             '--rounds', str(args.rounds)], env=env, capture_output=True,
            text=True, cwd=os.path.abspath(args.parent))
        if run.returncode != 0:
            raise RuntimeError(f'parent timing failed:\n{run.stderr}')
        return json.loads(run.stdout.strip().splitlines()[-1])

    results = {}
    if args.parent:
        results['parent (first)'] = parent_times()
    names = [n for n in VARIANTS if not args.only or n in args.only]
    libs = build_variants(names)
    cs = cases(torch)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device='cuda')
    real_load, real_splits = _build.load_library, da._num_splits
    real_route = da._mma_tiles
    for name in names:
        _, splits, cuda_cores = VARIANTS[name]
        lib = libs[name]
        _build.load_library = (real_load if lib is None else
                               (lambda _n, path=lib: ctypes.CDLL(path)))
        da._lib = None
        da._warps.cache_clear()
        da._num_splits = (real_splits if splits is None else
                          (lambda _b, _kvh, _t, s=splits: s))
        da._mma_tiles = ((lambda *_: 0) if cuda_cores else real_route)
        if name not in DIAGNOSTICS:
            for label, c in cs.items():
                got = chip_smoke.run_decode(da, c)
                ref = chip_smoke.run_decode_plain(da, c)
                err = chip_smoke.head_err(torch, got, ref, c['nv'])
                tol = chip_smoke.DECODE_TOL[label.split()[0]]
                if not err <= tol:
                    raise AssertionError(f'{name}, {label}: head error '
                                         f'{err}')
        runs = {label: (lambda c=c: chip_smoke.run_decode(da, c))
                for label, c in cs.items()}
        times = [time_all(torch, runs, flush)
                 for _ in range(args.rounds)]
        results[name] = {k: [t[k] for t in times] for k in runs}
    _build.load_library, da._num_splits = real_load, real_splits
    da._mma_tiles = real_route
    da._lib = None
    da._warps.cache_clear()
    if args.parent:
        results['parent (last)'] = parent_times()
    bounds = {label: chip_smoke.decode_bound(c, *chip_smoke.card_peaks(
        torch.cuda.get_device_name(0))[1:])[0] for label, c in cs.items()}
    for name, times in results.items():
        for label, ts in times.items():
            print(f'[steps] {name} | {label}: ' +
                  ' / '.join(f'{t:.4f}' for t in ts) +
                  f' ms (bound {bounds[label]:.4f})', flush=True)
    print(json.dumps({'bounds': bounds, 'ms': results}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
