"""PinotFS: deep-store filesystem abstraction (the port of
pinot_tpu/spi/filesystem.py).

Reference analogue: pinot-spi/.../spi/filesystem/PinotFS.java:45 +
BasePinotFS:30 (copy/move/delete/open/length/listFiles/mkdir, URI-scheme
dispatch) with plugin impls for s3/gcs/adls/hdfs
(pinot-plugins/pinot-file-system/). Local FS ships here; remote stores
register their scheme via register_fs (cloud SDKs are not in this image —
the SPI boundary is what matters for parity)."""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import BinaryIO, Callable
from urllib.parse import urlparse


class PinotFS:
    """All paths are URI strings; scheme picks the implementation."""

    def mkdir(self, uri: str) -> None:
        raise NotImplementedError

    def delete(self, uri: str, force: bool = False) -> bool:
        raise NotImplementedError

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        raise NotImplementedError

    def copy(self, src: str, dst: str) -> bool:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def length(self, uri: str) -> int:
        raise NotImplementedError

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        raise NotImplementedError

    def open(self, uri: str) -> BinaryIO:
        raise NotImplementedError

    def copy_to_local(self, src_uri: str, local_path: str) -> None:
        raise NotImplementedError

    def copy_from_local(self, local_path: str, dst_uri: str) -> None:
        raise NotImplementedError

    def is_directory(self, uri: str) -> bool:
        raise NotImplementedError


def _local(uri: str) -> Path:
    p = urlparse(uri)
    if p.scheme in ("", "file"):
        return Path(p.path if p.scheme else uri)
    raise ValueError(f"not a local uri: {uri}")


class LocalPinotFS(PinotFS):
    """Reference: LocalPinotFS.java."""

    def mkdir(self, uri: str) -> None:
        _local(uri).mkdir(parents=True, exist_ok=True)

    def delete(self, uri: str, force: bool = False) -> bool:
        p = _local(uri)
        if not p.exists():
            return False
        if p.is_dir():
            if any(p.iterdir()) and not force:
                raise OSError(f"{uri} is a non-empty directory (use force)")
            shutil.rmtree(p)
        else:
            p.unlink()
        return True

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        s, d = _local(src), _local(dst)
        if d.exists():
            if not overwrite:
                return False
            if d.is_dir():
                shutil.rmtree(d)
            else:
                d.unlink()
        d.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(s), str(d))
        return True

    def copy(self, src: str, dst: str) -> bool:
        s, d = _local(src), _local(dst)
        d.parent.mkdir(parents=True, exist_ok=True)
        if s.is_dir():
            shutil.copytree(s, d, dirs_exist_ok=True)
        else:
            shutil.copy2(s, d)
        return True

    def exists(self, uri: str) -> bool:
        return _local(uri).exists()

    def length(self, uri: str) -> int:
        return _local(uri).stat().st_size

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        p = _local(uri)
        if not p.is_dir():
            return []
        it = p.rglob("*") if recursive else p.iterdir()
        return sorted(str(c) for c in it if c.is_file())

    def open(self, uri: str) -> BinaryIO:
        return open(_local(uri), "rb")

    def copy_to_local(self, src_uri: str, local_path: str) -> None:
        self.copy(src_uri, local_path)

    def copy_from_local(self, local_path: str, dst_uri: str) -> None:
        self.copy(local_path, dst_uri)

    def is_directory(self, uri: str) -> bool:
        return _local(uri).is_dir()


_FS_REGISTRY: dict[str, Callable[[], PinotFS]] = {
    "": LocalPinotFS,
    "file": LocalPinotFS,
}


def register_fs(scheme: str, factory: Callable[[], PinotFS]) -> None:
    """Plugin hook (reference: PinotFSFactory.register)."""
    _FS_REGISTRY[scheme] = factory


# schemes whose plugin module name differs from the scheme itself
_SCHEME_MODULES = {"gs": "gcs", "abfs": "adls", "abfss": "adls",
                   "adl2": "adls"}


def get_fs(uri: str) -> PinotFS:
    scheme = urlparse(uri).scheme
    factory = _FS_REGISTRY.get(scheme)
    if factory is None:
        # plugin discovery: pinot_tpu_torch.plugins.filesystem.<module> registers
        # its scheme(s) on import (reference: PinotFSFactory + PluginManager)
        from .plugins import resolve

        try:
            resolve("filesystem", _SCHEME_MODULES.get(scheme, scheme))
        except ValueError:
            pass
        factory = _FS_REGISTRY.get(scheme)
        if factory is None:
            raise ValueError(
                f"no PinotFS registered for scheme {scheme!r} "
                f"(register via spi.filesystem.register_fs)") from None
    return factory()


from .plugins import register_kind as _register_kind  # noqa: E402

_register_kind("filesystem", _FS_REGISTRY.get)
