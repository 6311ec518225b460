"""Content-addressed shard manifests: the checkpoint commit protocol.

The port's copy of the part of ``skypilot_tpu/data/ckpt_manifest.py``
the adapter registry, the checkpoints, the weight fan-out and the RL
policy store use, byte-compatible with it: a directory written by
either package reads in the other.

A checkpoint directory is a bag of shard files plus ONE manifest
(:data:`MANIFEST_NAME`) listing every shard with its sha256 and size.
The manifest is the commit marker:

1. write every shard, fsync each;
2. serialize the manifest, embed the sha256 of its own payload;
3. write it to a tmp name in the same directory, fsync;
4. ``os.replace`` onto :data:`MANIFEST_NAME`, fsync the directory.

A save that dies before step 4 leaves no manifest or the previous one;
a torn or corrupt manifest fails its embedded payload checksum and
reads as absent.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

MANIFEST_NAME = 'MANIFEST.skyt.json'
FORMAT = 'skyt-ckpt-manifest-v1'
# Partial downloads / in-flight writes carry this infix; ``build`` skips
# them.
TMP_INFIX = '.skyt-tmp'

_CHUNK = 1024 * 1024


def hash_file(path: str) -> Dict[str, Any]:
    """``{'sha256': hex, 'size': bytes}`` of one file, streamed."""
    sha = hashlib.sha256()
    size = 0
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(_CHUNK), b''):
            sha.update(chunk)
            size += len(chunk)
    return {'sha256': sha.hexdigest(), 'size': size}


def manifest_path(root: str) -> str:
    return os.path.join(root, MANIFEST_NAME)


def _canonical(payload: Dict[str, Any]) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(',', ':')).encode()


def build(root: str, step: Optional[int] = None,
          extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Walk ``root``, hash every shard file, return the manifest
    payload (not yet committed — see :func:`write`). Shard paths are
    '/'-separated and relative to ``root``; the manifest itself and
    tmp files are excluded."""
    shards: List[Dict[str, Any]] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name == MANIFEST_NAME or TMP_INFIX in name:
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root).replace(os.sep, '/')
            entry = {'path': rel}
            entry.update(hash_file(full))
            shards.append(entry)
    shards.sort(key=lambda e: e['path'])
    payload: Dict[str, Any] = {'shards': shards}
    if step is not None:
        payload['step'] = int(step)
    if extra:
        payload.update(extra)
    return payload


def write(root: str, payload: Dict[str, Any]) -> str:
    """Commit ``payload`` as ``root``'s manifest: tmp + fsync + atomic
    rename + directory fsync. Returns the manifest path."""
    doc = {
        'format': FORMAT,
        'payload': payload,
        'payload_sha256': hashlib.sha256(
            _canonical(payload)).hexdigest(),
    }
    final = manifest_path(root)
    tmp = f'{final}{TMP_INFIX}.{os.getpid()}'
    data = json.dumps(doc, sort_keys=True, indent=1).encode()
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _fsync_dir(root)
    return final


def read(root: str) -> Optional[Dict[str, Any]]:
    """The committed manifest payload, or None when the directory has
    no manifest OR the manifest is torn or corrupt (unparseable, wrong
    format, or failing its embedded payload checksum)."""
    path = manifest_path(root)
    try:
        with open(path, 'rb') as f:
            raw = f.read()
    except OSError:
        return None
    try:
        doc = json.loads(raw)
    except ValueError:
        logger.warning('torn/unparseable manifest ignored: %s', path)
        return None
    if not isinstance(doc, dict) or doc.get('format') != FORMAT:
        logger.warning('unknown manifest format ignored: %s', path)
        return None
    payload = doc.get('payload')
    if not isinstance(payload, dict):
        return None
    digest = hashlib.sha256(_canonical(payload)).hexdigest()
    if digest != doc.get('payload_sha256'):
        logger.warning('manifest payload checksum mismatch ignored: '
                       '%s', path)
        return None
    return payload


def shard_map(payload: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``rel_path -> shard entry`` for one manifest payload."""
    return {s['path']: s for s in payload.get('shards', ())}


def diff(old: Optional[Dict[str, Any]],
         new: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Shards of ``new`` absent from ``old`` or whose digest changed:
    the incremental-refresh transfer set. ``old=None`` means a cold
    start: every shard moves."""
    if old is None:
        return list(new.get('shards', ()))
    prev = shard_map(old)
    out = []
    for shard in new.get('shards', ()):
        before = prev.get(shard['path'])
        if before is None or before['sha256'] != shard['sha256']:
            out.append(shard)
    return out


def verify(root: str,
           payload: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Shards missing on disk or failing their digest; an empty list
    means ``root`` holds a verified-complete copy of the manifest."""
    bad = []
    for shard in payload.get('shards', ()):
        full = os.path.join(root, *shard['path'].split('/'))
        try:
            entry = hash_file(full)
        except OSError:
            bad.append(shard)
            continue
        if entry['sha256'] != shard['sha256'] or \
                entry['size'] != shard['size']:
            bad.append(shard)
    return bad


def _fsync_dir(path: str) -> None:
    """Durably record a rename: fsync the containing directory (errors
    swallowed on filesystems that refuse directory fds; the rename
    itself is still atomic)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
