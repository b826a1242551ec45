"""File reading behind the reference's FileClient facade (reference:
basicsr/utils/file_client.py:147-183), the counterpart of
``edvr_tpu/data/file_client.py`` with the disk backend only; LMDB and
memcached are not ported (ROADMAP A.9)."""

from __future__ import annotations


class DiskBackend:

    def get(self, filepath) -> bytes:
        with open(str(filepath), 'rb') as f:
            return f.read()


class FileClient:
    """Reads a file's bytes through a named backend."""

    _backends = {'disk': DiskBackend}

    def __init__(self, backend='disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(f'Backend {backend} is not supported. '
                             f'Currently supported ones are '
                             f'{list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key='default'):
        return self.client.get(filepath)
