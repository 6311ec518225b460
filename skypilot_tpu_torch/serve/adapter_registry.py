"""Content-addressed LoRA adapter artifacts (the serving registry).

The port of ``skypilot_tpu/serve/adapter_registry.py``, with the same
files on disk, so an adapter exported by either package loads in the
other. An adapter directory is a tiny checkpoint: digest-named ``.npy``
shards (one per A/B leaf) committed under the ``data/ckpt_manifest.py``
protocol. The manifest's ``adapter`` payload carries the adapter's
name, rank, alpha and the content digest of the BASE weights it was
trained against; an engine serving another base refuses it
(``ContinuousBatchingEngine.register_adapter``).

Layout (one directory per adapter under a registry root)::

    <root>/<name>/
        wq_a-<sha12>.npy  wq_b-<sha12>.npy
        wv_a-<sha12>.npy  wv_b-<sha12>.npy
        MANIFEST.skyt.json     # commit marker, adapter metadata
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.data import ckpt_manifest
from skypilot_tpu_torch.models.convert import tensor_to_numpy

logger = logging.getLogger(__name__)

ADAPTER_LEAVES = ('wq_a', 'wq_b', 'wv_a', 'wv_b')


def _host(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return tensor_to_numpy(value)
    return np.asarray(value)


def _leaf_bytes(value: Any) -> bytes:
    """A leaf's raw bytes (a bf16 tensor's without a numpy bf16)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(value).tobytes()


def _leaves_with_path(node: Any, path: Tuple[str, ...] = ()):
    """(key path, leaf) pairs of a params dict, the key path spelled as
    the reference's ``str(jax key path)`` (``DictKey(key='...')`` per
    dict level, ``GetAttrKey(name='q'|'scale')`` inside a W8A8
    ``QTensor``), so both packages give one digest for one tree."""
    if isinstance(node, dict):
        for key, value in node.items():
            yield from _leaves_with_path(value,
                                         path + (f'DictKey(key={key!r})',))
    elif hasattr(node, 'q') and hasattr(node, 'scale'):
        for name in ('q', 'scale'):
            yield (path + (f'GetAttrKey(name={name!r})',),
                   getattr(node, name))
    else:
        yield path, node


def params_digest(params: Any) -> str:
    """Content digest of a params dict (the base model's identity):
    sha256 over every leaf's key path and raw bytes, in the order of
    the key paths' text; the same digest as the reference's for the
    same numbers."""
    sha = hashlib.sha256()
    leaves = []
    for path, leaf in _leaves_with_path(params):
        text = '(' + ', '.join(path) + (',)' if len(path) == 1 else ')')
        leaves.append((text, leaf))
    for text, leaf in sorted(leaves, key=lambda kv: kv[0]):
        sha.update(text.encode())
        sha.update(_leaf_bytes(leaf))
    return sha.hexdigest()


def checkpoint_digest(root: str) -> str:
    """Content digest of a checkpoint directory. A committed
    ``MANIFEST.skyt.json`` is authoritative (digest of its canonical
    payload); otherwise the weight and config files are hashed."""
    payload = ckpt_manifest.read(root)
    if payload is not None:
        blob = json.dumps(payload, sort_keys=True,
                          separators=(',', ':')).encode()
        return hashlib.sha256(blob).hexdigest()
    sha = hashlib.sha256()
    names = sorted(
        name for name in os.listdir(root)
        if name.endswith(('.safetensors', '.json', '.npz'))
        and ckpt_manifest.TMP_INFIX not in name)
    for name in names:
        entry = ckpt_manifest.hash_file(os.path.join(root, name))
        sha.update(f'{name}:{entry["sha256"]}:{entry["size"]}'.encode())
    return sha.hexdigest()


def _save_leaf(directory: str, key: str, array: np.ndarray) -> str:
    """Write one leaf as a digest-named .npy shard; returns the shard
    file name (identical weights reuse the same name)."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(array))
    data = buf.getvalue()
    digest = hashlib.sha256(data).hexdigest()[:12]
    name = f'{key}-{digest}.npy'
    final = os.path.join(directory, name)
    if not os.path.exists(final):
        tmp = f'{final}{ckpt_manifest.TMP_INFIX}.{os.getpid()}'
        with open(tmp, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    return name


def export_adapter(root: str, name: str, lora: Any, *,
                   alpha: float, base_digest: str,
                   step: Optional[int] = None,
                   extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Commit adapter ``name`` (leaves: tensors or numpy arrays) under
    registry ``root``: digest-named A/B shards + the manifest commit
    marker. Returns the adapter directory. Stale shards of an earlier
    export of this name are removed before the new manifest commits."""
    if not name or '/' in name or name.startswith('.'):
        raise ValueError(f'bad adapter name {name!r}')
    directory = os.path.join(os.path.expanduser(root), name)
    os.makedirs(directory, exist_ok=True)
    host = {key: _host(lora[key]) for key in ADAPTER_LEAVES}
    rank = int(host['wq_a'].shape[-1])
    files = {key: _save_leaf(directory, key, host[key])
             for key in ADAPTER_LEAVES}
    keep = set(files.values()) | {ckpt_manifest.MANIFEST_NAME}
    for existing in os.listdir(directory):
        if existing not in keep and \
                ckpt_manifest.TMP_INFIX not in existing:
            os.unlink(os.path.join(directory, existing))
    meta: Dict[str, Any] = {
        'name': name,
        'base_digest': base_digest,
        'rank': rank,
        'alpha': float(alpha),
        'files': files,
    }
    if extra_meta:
        meta.update(extra_meta)
    payload = ckpt_manifest.build(directory, step=step,
                                  extra={'adapter': meta})
    ckpt_manifest.write(directory, payload)
    return directory


def load_adapter(directory: str, *,
                 expect_base_digest: Optional[str] = None
                 ) -> Tuple[str, Dict[str, np.ndarray], Dict[str, Any]]:
    """Load one committed adapter: ``(name, leaves as numpy, meta)``.
    Raises on a missing or torn manifest, on shards failing their
    digest, and (with ``expect_base_digest``) on a base mismatch."""
    payload = ckpt_manifest.read(directory)
    if payload is None:
        raise FileNotFoundError(
            f'{directory} has no committed adapter manifest')
    meta = payload.get('adapter')
    if not isinstance(meta, dict) or 'files' not in meta:
        raise ValueError(f'{directory} manifest has no adapter payload')
    if expect_base_digest and meta.get('base_digest') and \
            meta['base_digest'] != expect_base_digest:
        raise ValueError(
            f'adapter {meta.get("name")!r} was trained against base '
            f'{meta["base_digest"][:12]}...; this deployment serves '
            f'{expect_base_digest[:12]}... (re-export against the '
            f'served base)')
    bad = ckpt_manifest.verify(directory, payload)
    if bad:
        raise ValueError(
            f'adapter shards failed verification in {directory}: '
            f'{[s["path"] for s in bad]}')
    lora = {key: np.load(os.path.join(directory, meta['files'][key]))
            for key in ADAPTER_LEAVES}
    return str(meta.get('name') or
               os.path.basename(directory.rstrip('/'))), lora, meta


def scan_registry(root: str) -> List[str]:
    """Adapter directories with committed manifests under ``root``
    (sorted by name; uncommitted subdirectories are skipped)."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        directory = os.path.join(root, name)
        if os.path.isdir(directory) and \
                os.path.exists(ckpt_manifest.manifest_path(directory)):
            out.append(directory)
    return out


def load_registry_into(engine: Any, root: str) -> List[str]:
    """Register every committed adapter under ``root`` with a
    continuous engine (base digest checked by ``load_adapter`` against
    the engine's, and again by ``register_adapter``). Returns the
    registered names; a corrupt or mismatched adapter is skipped with a
    warning."""
    names = []
    expect = getattr(engine, 'base_digest', '') or None
    for directory in scan_registry(root):
        try:
            name, lora, meta = load_adapter(
                directory, expect_base_digest=expect)
            engine.register_adapter(
                name, lora, alpha=float(meta.get('alpha', 16.0)),
                base_digest=meta.get('base_digest') or None)
            names.append(name)
        except Exception as e:  # pylint: disable=broad-except
            logger.warning('skipping adapter %s: %s: %s', directory,
                           type(e).__name__, e)
    return names
