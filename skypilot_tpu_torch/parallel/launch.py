"""Start the ranks of a mesh: one process per shard.

The port's counterpart of JAX's single-controller device list. The
reference drives every device of a mesh from one process; here
``launch(target, world_size, *args)`` spawns ``world_size`` processes
(``torch.multiprocessing``, start method ``spawn``), each of which joins
one ``torch.distributed`` process group and runs ``target(rank,
world_size, *args)``; rank 0's caller gets every rank's return value.

* The group meets through a ``file://`` store in a fresh temporary
  directory, never a fixed port, so launches running side by side (test
  workers, two servers) cannot collide.
* Backend rule (``choose_backend``): ``nccl`` when every rank has a GPU
  of its own; ``gloo`` when ranks share a device (two ranks on one
  card) or run on the CPU. The choice and its reason are printed. A
  backend that fails to initialise raises; it is never swapped for
  another.
* Rank ``r`` computes on ``cuda:(r % device_count)`` unless the caller
  names the CPU (``device='cpu'``).
* A rank that raises or dies ends the launch: the others are
  terminated and ``launch`` raises ``RankFailed`` carrying the failed
  rank's traceback. Each rank also dies with its parent (Linux
  ``PR_SET_PDEATHSIG``), so no rank outlives a killed launcher.

``target`` is a callable importable by reference or a
``'module:function'`` string; the spawned ranks import only its module
(and what it imports), never the launcher's ``__main__`` test module.
Return values travel through a pipe: keep them to plain Python and
numpy values.
"""
from __future__ import annotations

import datetime
import importlib
import os
import queue as queue_lib
import shutil
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

# Collective timeout: an idle driver sends keep-alive plans well inside
# it (inference/sharding.StepChannel), so only a dead peer reaches it.
DEFAULT_TIMEOUT_S = 600.0


class RankFailed(RuntimeError):
    """A rank of a launch raised or died; the message holds its
    traceback (or its exit code)."""


def choose_backend(world_size: int, device_type: str,
                   device_count: Optional[int] = None) -> Tuple[str, str]:
    """(backend, reason): ``nccl`` when every rank has its own GPU,
    ``gloo`` when ranks share a device or run on the CPU (NCCL refuses
    two ranks on one device)."""
    if device_type == 'cpu':
        return 'gloo', 'ranks run on the CPU'
    count = (torch.cuda.device_count() if device_count is None
             else device_count)
    if count >= world_size:
        return 'nccl', f'{world_size} ranks on {count} GPUs: one GPU each'
    return 'gloo', (f'{world_size} ranks share {count} GPU(s); NCCL '
                    'refuses two ranks on one device')


def rank_device(rank: int, device_type: str) -> torch.device:
    """``cuda:(rank % device_count)``, or the CPU when asked for."""
    if device_type == 'cpu':
        return torch.device('cpu')
    return torch.device('cuda', rank % max(torch.cuda.device_count(), 1))


def _resolve(target: Union[str, Callable[..., Any]]) -> Callable[..., Any]:
    if callable(target):
        return target
    module, _, name = target.partition(':')
    return getattr(importlib.import_module(module), name)


def _die_with_parent() -> None:
    if not sys.platform.startswith('linux'):
        return
    try:
        import ctypes
        libc = ctypes.CDLL('libc.so.6', use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except OSError:
        pass


def _rank_main(rank, world_size, init_file, backend, device_type, target,
               args, results) -> None:
    _die_with_parent()
    import torch.distributed as dist
    try:
        device = rank_device(rank, device_type)
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method='file://' + init_file, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        out = _resolve(target)(rank, world_size, *args)
        results.put((rank, 'ok', out))
    except BaseException:  # pylint: disable=broad-except
        results.put((rank, 'error', traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)  # peers may be blocked in a collective: no teardown
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(target: Union[str, Callable[..., Any]], world_size: int,
           *args: Any, device: str = 'cuda') -> List[Any]:
    """Run ``target(rank, world_size, *args)`` on ``world_size`` spawned
    ranks; returns their return values in rank order, or raises
    ``RankFailed`` as soon as one rank fails (the rest are terminated).
    The ranks inherit the environment (``OMP_NUM_THREADS`` caps their
    CPU threads)."""
    import torch.multiprocessing as mp
    device_type = torch.device(device).type
    backend, reason = choose_backend(world_size, device_type)
    print(f'[launch] {world_size} ranks on {device_type}: backend '
          f'{backend} ({reason})', file=sys.stderr, flush=True)
    ctx = mp.get_context('spawn')
    tmp = tempfile.mkdtemp(prefix='skyt-ranks-')
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, name=f'rank{rank}', daemon=True,
        args=(rank, world_size, os.path.join(tmp, 'store'), backend,
              device_type, target, args, results))
        for rank in range(world_size)]
    outputs: List[Any] = [None] * world_size
    done = set()
    failures = {}
    deadline = None
    previous = _terminate_on_sigterm()
    try:
        for proc in procs:
            proc.start()
        while len(done) < world_size:
            if deadline is not None and time.monotonic() > deadline:
                raise RankFailed('\n'.join(
                    failures[r] for r in sorted(failures)))
            try:
                rank, status, payload = results.get(timeout=0.2)
            except queue_lib.Empty:
                for rank, proc in enumerate(procs):
                    if (rank not in done and rank not in failures and
                            proc.exitcode not in (None, 0)):
                        failures[rank] = (f'rank {rank} died with exit '
                                          f'code {proc.exitcode}')
                        deadline = deadline or time.monotonic() + 1.0
                continue
            if status == 'error':
                # A peer's failure (a reset connection) can land first:
                # gather the others for a moment, then report them all.
                failures[rank] = f'rank {rank} failed:\n{payload}'
                deadline = deadline or time.monotonic() + 1.0
                done.add(rank)
                continue
            outputs[rank] = payload
            done.add(rank)
        if failures:
            raise RankFailed('\n'.join(failures[r] for r in sorted(failures)))
        for proc in procs:
            proc.join(timeout=60)
        return outputs
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            if proc.pid is not None:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=10)
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _terminate_on_sigterm():
    """In the main thread, make SIGTERM unwind ``launch`` (so its
    ``finally`` stops the ranks); returns the handler it replaced."""
    import threading
    if threading.current_thread() is not threading.main_thread():
        return None

    def handler(signum, frame):
        raise SystemExit(128 + signum)

    return signal.signal(signal.SIGTERM, handler)
