"""Cloud-storage path abstraction (pathlib-like), local + OSS.

The port's copy of det3d_tpu/utils/cloudpath.py, kept line for line (host
code in both packages, no torch), so that both give the same results.

Parity: det3d/datasets/utils/oss.py (OSSPath :119 — a pathlib clone over
Aliyun OSS used to read datasets from cloud storage, plus get_site :108).
The reference hard-depends on the ``oss2`` SDK; here the SDK is gated:
``smart_path("oss://bucket/key")`` returns an OSSPath when oss2 is
importable and raises a clear error otherwise, while plain paths return
``pathlib.Path`` — so dataset code can take either transparently
(the reference datasets do ``if str(path).startswith("oss://")``).
"""

from __future__ import annotations

import os
from pathlib import Path

try:                                                   # pragma: no cover
    import oss2
    _HAS_OSS = True
except ImportError:
    oss2 = None
    _HAS_OSS = False


def smart_path(path):
    """str/Path -> Path for local paths, OSSPath for oss:// URLs."""
    s = str(path)
    if s.startswith("oss://"):
        if not _HAS_OSS:
            raise ImportError(
                "oss2 SDK is not available in this environment; "
                "oss:// paths require it (pip install oss2)")
        return OSSPath(s)
    return Path(s)


def is_oss_path(path) -> bool:
    return str(path).startswith("oss://")


class OSSPath:
    """Minimal pathlib-like view of an oss://bucket/key object tree.

    Surface kept from the reference OSSPath: ``name``, ``stem``,
    ``suffix``, ``parent``, ``exists()``, ``open()``, ``read_bytes()``,
    ``read_text()``, ``iterdir()``, ``glob()`` (prefix + fnmatch), and
    ``/`` joining. Credentials come from the standard env vars
    (OSS_ACCESS_KEY_ID / OSS_ACCESS_KEY_SECRET / OSS_ENDPOINT).
    """

    def __init__(self, url: str):
        assert url.startswith("oss://"), url
        rest = url[len("oss://"):]
        self.bucket_name, _, self.key = rest.partition("/")
        self._bucket = None

    # -- pure-path surface (no SDK needed) ---------------------------------
    def __str__(self):
        return f"oss://{self.bucket_name}/{self.key}"

    __repr__ = __str__

    def __truediv__(self, other):
        key = self.key.rstrip("/")
        return OSSPath(f"oss://{self.bucket_name}/{key}/{other}"
                       if key else f"oss://{self.bucket_name}/{other}")

    def __eq__(self, other):
        return str(self) == str(other)

    def __hash__(self):
        return hash(str(self))

    @property
    def name(self):
        return self.key.rsplit("/", 1)[-1]

    @property
    def stem(self):
        return self.name.rsplit(".", 1)[0]

    @property
    def suffix(self):
        n = self.name
        return "." + n.rsplit(".", 1)[1] if "." in n else ""

    @property
    def parent(self):
        key = self.key.rstrip("/")
        head = key.rsplit("/", 1)[0] if "/" in key else ""
        return OSSPath(f"oss://{self.bucket_name}/{head}")

    # -- IO surface (SDK-gated) --------------------------------------------
    def _b(self):                                      # pragma: no cover
        if self._bucket is None:
            auth = oss2.Auth(os.environ["OSS_ACCESS_KEY_ID"],
                             os.environ["OSS_ACCESS_KEY_SECRET"])
            self._bucket = oss2.Bucket(auth, os.environ["OSS_ENDPOINT"],
                                       self.bucket_name)
        return self._bucket

    def exists(self) -> bool:                          # pragma: no cover
        return bool(self._b().object_exists(self.key))

    def read_bytes(self) -> bytes:                     # pragma: no cover
        return self._b().get_object(self.key).read()

    def read_text(self, encoding="utf-8") -> str:      # pragma: no cover
        return self.read_bytes().decode(encoding)

    def open(self, mode="rb"):                         # pragma: no cover
        import io
        if "r" not in mode:
            raise NotImplementedError("OSSPath.open is read-only")
        data = self.read_bytes()
        return io.BytesIO(data) if "b" in mode else io.StringIO(
            data.decode("utf-8"))

    def iterdir(self):                                 # pragma: no cover
        prefix = self.key.rstrip("/") + "/" if self.key else ""
        for obj in oss2.ObjectIterator(self._b(), prefix=prefix,
                                       delimiter="/"):
            yield OSSPath(f"oss://{self.bucket_name}/{obj.key}")

    def glob(self, pattern: str):                      # pragma: no cover
        import fnmatch
        prefix = self.key.rstrip("/") + "/" if self.key else ""
        for obj in oss2.ObjectIterator(self._b(), prefix=prefix):
            rel = obj.key[len(prefix):]
            if fnmatch.fnmatch(rel, pattern):
                yield OSSPath(f"oss://{self.bucket_name}/{obj.key}")
