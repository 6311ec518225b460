"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so
         csrc/<name>.cu

Host code (``csrc/<name>.cc``, the sequence packer) is compiled the
same way by the host C++ compiler (``c++``, else ``g++``)::

    c++ -O3 -std=c++17 -shared -fPIC -o build/torch_kernels/lib<name>-<hash>.so
        csrc/<name>.cc

Libraries go into ``build/torch_kernels/`` beside the package (``build/``
is listed in ``.gitignore``). A library is built at first use, from the
sources in this checkout only, and rebuilt when the hash of its source,
the ``csrc`` headers (for CUDA sources) or the flags changes.
``build_all`` starts one ``nvcc`` per CUDA source, all at once. A
missing compiler or a failed build raises with the compiler's output;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_kernels')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo']
HOST_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC']

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, '*.cu')))


def _source(name: str) -> str:
    """``csrc/<name>.cu``, else ``csrc/<name>.cc``."""
    for ext in ('.cu', '.cc'):
        path = os.path.join(CSRC_DIR, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f'no source csrc/{name}.cu or csrc/{name}.cc')


def find_cxx() -> str:
    cxx = shutil.which('c++') or shutil.which('g++')
    if cxx is None:
        raise RuntimeError('no host C++ compiler found (c++, g++): the '
                           'port builds its host libraries from source at '
                           'first use')
    return cxx


def find_nvcc() -> str:
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        candidate = os.path.join(cuda_home, 'bin', 'nvcc')
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError(
            'nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): '
            'the port builds its CUDA kernels from source at first use')
    return nvcc


def _digest(name: str) -> str:
    h = hashlib.sha256()
    src = _source(name)
    cuda = src.endswith('.cu')
    h.update(' '.join(NVCC_FLAGS if cuda else HOST_FLAGS).encode())
    paths = [src] + (sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh')))
                     if cuda else [])
    for path in paths:
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f'lib{name}-{_digest(name)}.so')


def _start(name: str, compiler: str
           ) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start compiling ``name`` into a temp file with ``compiler``
    (``nvcc`` for a ``.cu`` source, the host compiler for ``.cc``); None
    when current. Returns (process, library path, temp path)."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    src = _source(name)
    flags = NVCC_FLAGS if src.endswith('.cu') else HOST_FLAGS
    cmd = [compiler] + flags + ['-I', CSRC_DIR, '-o', tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, job: Optional[Tuple[subprocess.Popen, str, str]]
            ) -> None:
    if job is None:
        return
    proc, out, tmp = job
    output, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f'{os.path.basename(proc.args[0])} failed building '
            f'{os.path.relpath(proc.args[-1], _PKG_DIR)} '
            f'(exit {proc.returncode}):\n{output}')
    os.replace(tmp, out)


def build_all() -> List[str]:
    """Build every stale kernel library, one ``nvcc`` per source in
    parallel. Returns the library paths."""
    names = sources()
    with _lock:
        stale = [n for n in names if not os.path.exists(library_path(n))]
        if stale:
            nvcc = find_nvcc()
            jobs = [(n, _start(n, nvcc)) for n in stale]
            errors = []
            for n, job in jobs:
                try:
                    _finish(n, job)
                except RuntimeError as e:
                    errors.append(str(e))
            if errors:
                raise RuntimeError('\n\n'.join(errors))
    return [library_path(n) for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cc``), built first
    if stale."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not os.path.exists(path):
            cuda = _source(name).endswith('.cu')
            _finish(name, _start(name, find_nvcc() if cuda else find_cxx()))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
        return lib
