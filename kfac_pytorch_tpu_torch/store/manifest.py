"""Checkpoint manifests, the atomic commit point of a checkpoint (the
port's own copy of ``kfac_pytorch_tpu/store/manifest.py``; stdlib only).

A checkpoint epoch is COMMITTED exactly when its manifest object exists.
The writer puts every blob first, then ``checkpoint-<epoch>.manifest.json``
LAST, one atomic put, so a crash at any earlier point leaves blobs with
no manifest (an uncommitted epoch the resume scan skips), never a
manifest naming blobs that do not exist. The manifest records a sha256
and a size per blob, which the restore checks before it reads a byte.

The JSON schema and its encoding are the JAX package's, byte for byte:
its ``parse_manifest`` and ``verify_blob`` accept a manifest the port
wrote.
"""

import hashlib
import json
import re

FORMAT = 1

#: a committed epoch's manifest object, at the namespace top level
MANIFEST_RE = re.compile(r'^checkpoint-(\d+)\.manifest\.json$')


def manifest_key(epoch):
    return f'checkpoint-{int(epoch)}.manifest.json'


def blob_sha256(data):
    return hashlib.sha256(data).hexdigest()


def build_manifest(epoch, kind, blobs, stamp=None):
    """``blobs``: {key: bytes} or {key: (sha256_hex, size)}. ``stamp``:
    a ``world.json``-style dict whose integer ``num_devices``/``gen``/
    ``lineage`` are copied in."""
    entries = {}
    for key, spec in blobs.items():
        if isinstance(spec, (bytes, bytearray, memoryview)):
            entries[str(key)] = {'sha256': blob_sha256(spec),
                                 'size': len(spec)}
        else:
            sha, size = spec
            entries[str(key)] = {'sha256': str(sha), 'size': int(size)}
    manifest = {'format': FORMAT, 'epoch': int(epoch),
                'kind': str(kind), 'blobs': entries}
    for field in ('num_devices', 'gen', 'lineage'):
        if stamp and isinstance(stamp.get(field), int):
            manifest[field] = stamp[field]
    return manifest


def encode_manifest(manifest):
    return (json.dumps(manifest, sort_keys=True, indent=1)
            + '\n').encode()


def parse_manifest(raw):
    """Decode manifest bytes; ``None`` for anything unparseable or
    structurally wrong: a torn or corrupt manifest is an UNCOMMITTED
    epoch, never a crash."""
    try:
        manifest = json.loads(bytes(raw).decode())
        if (not isinstance(manifest, dict)
                or not isinstance(manifest.get('blobs'), dict)
                or not isinstance(manifest.get('epoch'), int)):
            return None
        for spec in manifest['blobs'].values():
            if (not isinstance(spec, dict)
                    or not isinstance(spec.get('sha256'), str)
                    or not isinstance(spec.get('size'), int)):
                return None
        return manifest
    except (ValueError, UnicodeDecodeError):
        return None


def manifest_epochs(store):
    """{epoch: manifest key} for every committed epoch in the namespace:
    the resume scan's candidate set."""
    out = {}
    for key in store.list(''):
        m = MANIFEST_RE.match(key)
        if m:
            out[int(m.group(1))] = key
    return out


def read_manifest(store, epoch):
    """The parsed manifest for ``epoch``, or ``None`` (absent or
    unparseable: either way the epoch is uncommitted)."""
    raw = store.get(manifest_key(epoch))
    return None if raw is None else parse_manifest(raw)


def blob_problem(data, spec):
    """``None`` when ``data`` (the object's bytes, None when it is absent)
    matches its manifest entry, else the reason (``'missing'`` |
    ``'size_mismatch'`` | ``'hash_mismatch'``)."""
    if data is None:
        return 'missing'
    if len(data) != spec['size']:
        return 'size_mismatch'
    if blob_sha256(data) != spec['sha256']:
        return 'hash_mismatch'
    return None


def verify_blob(store, key, spec):
    """:func:`blob_problem` of the stored object ``key``."""
    return blob_problem(store.get(key), spec)


def verify_epoch(store, manifest):
    """``[(key, reason)]`` for every blob of ``manifest`` that fails
    :func:`verify_blob`, in key order: empty when the epoch is intact."""
    problems = []
    for key in sorted(manifest['blobs']):
        reason = verify_blob(store, key, manifest['blobs'][key])
        if reason is not None:
            problems.append((key, reason))
    return problems
