"""A POSIX directory of atomic-rename blob files (the port's own copy of
the object store in ``kfac_pytorch_tpu/store/posix.py``, reduced to what
the checkpoint plane uses; stdlib only).

Keys map one to one onto files under the root (``a/b.pt`` is
``<root>/a/b.pt``). ``put`` writes the whole object to a temp name,
fsyncs it and renames it over the key, so a crash at any point leaves the
old object or the new one, never a torn one under the final name. Temp
files are never listed.
"""

import collections
import contextlib
import hashlib
import os

#: a ``head`` result: the object's generation token and its size
Meta = collections.namedtuple('Meta', ['generation', 'size'])

#: the part of the name of a temp file that a write in flight leaves
_TMP_MARKER = '.tmp-'


def _check_key(key):
    key = str(key)
    parts = key.split('/')
    if not key or key.startswith('/') or any(p in ('', '.', '..')
                                             for p in parts):
        raise ValueError(f'bad object key {key!r}')
    return key


class PosixStore:
    def __init__(self, root):
        # the root is created on the first write, not here: a read-only
        # attach never makes directories
        self.root = str(root)

    def __repr__(self):
        return f'PosixStore({self.root!r})'

    def _path(self, key):
        return os.path.join(self.root, *_check_key(key).split('/'))

    def get(self, key):
        """The object's bytes, or None when it does not exist."""
        try:
            with open(self._path(key), 'rb') as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            return None

    def head(self, key):
        """``(generation, size)`` of the object, or None when it does not
        exist. The generation is the JAX store's token, a content hash
        (the first 16 hex digits of the sha256), so a head reads the
        bytes."""
        data = self.get(key)
        if data is None:
            return None
        return Meta(hashlib.sha256(data).hexdigest()[:16], len(data))

    def delete(self, key):
        """Remove the object; whether it existed."""
        try:
            os.remove(self._path(key))
            return True
        except FileNotFoundError:
            return False

    def list(self, prefix=''):
        """Sorted keys starting with ``prefix``; temp files left by a write
        in flight are skipped."""
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            rel = '' if rel == '.' else rel.replace(os.sep, '/') + '/'
            for name in files:
                key = rel + name
                if _TMP_MARKER not in name and key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def put(self, key, data):
        """Atomic whole-object write: temp file, fsync, rename."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f'{path}{_TMP_MARKER}{os.getpid()}'
        try:
            with open(tmp, 'wb') as f:
                f.write(bytes(data))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
