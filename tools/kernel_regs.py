#!/usr/bin/env python3
"""Registers, spills and shared memory of every kernel in the port's CUDA
sources, as ``nvcc -Xptxas -v`` reports them.

    python3 tools/kernel_regs.py                       # this checkout
    python3 tools/kernel_regs.py --root OTHER_CHECKOUT --only paged_attention
    python3 tools/kernel_regs.py --compare OTHER_CHECKOUT --only paged_attention

Each ``skypilot_tpu_torch/csrc/<name>.cu`` is compiled with the flags of
``skypilot_tpu_torch/_build.py`` into a scratch object under the
git-ignored ``build/kernel_regs/``; one line per kernel (demangled name,
registers, spill bytes stored/loaded, static shared memory). With
``--compare`` both checkouts are compiled and every kernel whose numbers
differ is listed; the exit code is 1 if any differ or a kernel is
missing from either. Needs ``nvcc`` (the card's machine).
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from skypilot_tpu_torch import _build  # noqa: E402

_FUNC = re.compile(r"Compiling entry function '(\S+)'")
_REGS = re.compile(r'Used (\d+) registers')
_SPILL = re.compile(r'(\d+) bytes spill stores, (\d+) bytes spill loads')
_SMEM = re.compile(r'(\d+) bytes smem')


def demangle(names):
    tool = shutil.which('cu++filt') or os.path.join(
        os.path.dirname(_build.find_nvcc()), 'cu++filt')
    if not os.path.exists(tool):
        return list(names)
    out = subprocess.run([tool], input='\n'.join(names), capture_output=True,
                         text=True, check=True).stdout.split('\n')
    return out[:len(names)]


def report(root: str, name: str, tag: str):
    """{kernel: (registers, spill stores, spill loads, smem)} of one
    source of the checkout at ``root``."""
    csrc = os.path.join(root, 'skypilot_tpu_torch', 'csrc')
    out_dir = os.path.join(ROOT, 'build', 'kernel_regs', tag)
    os.makedirs(out_dir, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ('-shared',)]
    cmd = ([_build.find_nvcc()] + flags + ['-Xptxas', '-v', '-c', '-I', csrc,
           '-o', os.path.join(out_dir, name + '.o'),
           os.path.join(csrc, name + '.cu')])
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f'nvcc failed on {root}/{name}.cu:\n{run.stderr}')
    kernels, current = {}, None
    for line in run.stderr.splitlines():
        m = _FUNC.search(line)
        if m:
            current = m.group(1)
            kernels[current] = [0, 0, 0, 0]
            continue
        if current is None:
            continue
        if (m := _SPILL.search(line)):
            kernels[current][1:3] = [int(m.group(1)), int(m.group(2))]
        if (m := _REGS.search(line)):
            kernels[current][0] = int(m.group(1))
            if (s := _SMEM.search(line)):
                kernels[current][3] = int(s.group(1))
    pretty = demangle(list(kernels))
    return {p: tuple(v) for p, v in zip(pretty, kernels.values())}


def names_of(root: str, only):
    found = sorted(os.path.splitext(os.path.basename(p))[0] for p in
                   glob.glob(os.path.join(root, 'skypilot_tpu_torch', 'csrc',
                                          '*.cu')))
    return [n for n in found if not only or n in only]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=ROOT, help='checkout to compile')
    ap.add_argument('--compare', help='a second checkout to compare with')
    ap.add_argument('--only', nargs='*', help='source names (no .cu)')
    args = ap.parse_args(argv)
    roots = [('a', args.root)] + ([('b', args.compare)] if args.compare
                                  else [])
    jobs = [(tag, root, n) for tag, root in roots
            for n in names_of(root, args.only)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(lambda j: (j, report(j[1], j[2], j[0])),
                                jobs))
    by_root = {}
    for (tag, root, name), kernels in results:
        by_root.setdefault(tag, {}).update(
            {f'{name}: {k}': v for k, v in kernels.items()})
    for tag, root in roots:
        print(f'[regs] {root}')
        for k, (regs, st, ld, smem) in sorted(by_root[tag].items()):
            print(f'[regs]   {regs:3d} registers, spill {st}/{ld} bytes, '
                  f'{smem} bytes smem  {k}')
    if not args.compare:
        return 0
    a, b = by_root['a'], by_root['b']
    differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    for k in differ:
        print(f'[regs] DIFFERS {k}: {a.get(k)} vs {b.get(k)}')
    print(f'[regs] {len(set(a) & set(b))} kernels in both, '
          f'{len(differ)} differ')
    return 1 if differ else 0


if __name__ == '__main__':
    sys.exit(main())
