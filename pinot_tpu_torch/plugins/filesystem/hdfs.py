"""HDFS PinotFS, the port of pinot_tpu/plugins/filesystem/hdfs.py (reference: pinot-plugins/pinot-file-system/pinot-hdfs/
HadoopPinotFS.java).

Unlike the object stores, HDFS has real directories, so this is a direct
PinotFS implementation over ``pyarrow.fs.HadoopFileSystem`` (optional,
lazily imported; inject ``fs_factory`` to use another client — tests use
pyarrow's LocalFileSystem through the same adapter surface).
"""

from __future__ import annotations

from typing import BinaryIO, Callable
from urllib.parse import urlparse

from ...spi.filesystem import PinotFS, register_fs


def _default_fs_factory():
    try:
        from pyarrow import fs  # type: ignore[import-not-found]
    except ImportError as e:
        raise ImportError(
            "scheme 'hdfs' needs the pyarrow package (or inject "
            "HdfsPinotFS.fs_factory)") from e
    return fs.HadoopFileSystem("default")


def _path(uri: str) -> str:
    p = urlparse(uri)
    return p.path if p.scheme else uri


class HdfsPinotFS(PinotFS):
    fs_factory: Callable = staticmethod(_default_fs_factory)

    def __init__(self, filesystem=None):
        self._fs = filesystem if filesystem is not None else \
            type(self).fs_factory()

    def _info(self, uri: str):
        return self._fs.get_file_info([_path(uri)])[0]

    def mkdir(self, uri: str) -> None:
        self._fs.create_dir(_path(uri), recursive=True)

    def exists(self, uri: str) -> bool:
        from pyarrow import fs

        return self._info(uri).type != fs.FileType.NotFound

    def is_directory(self, uri: str) -> bool:
        from pyarrow import fs

        return self._info(uri).type == fs.FileType.Directory

    def length(self, uri: str) -> int:
        return self._info(uri).size

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        from pyarrow import fs

        sel = fs.FileSelector(_path(uri), recursive=recursive)
        return sorted(i.path for i in self._fs.get_file_info(sel))

    def delete(self, uri: str, force: bool = False) -> bool:
        from pyarrow import fs

        info = self._info(uri)
        if info.type == fs.FileType.NotFound:
            return False
        if info.type == fs.FileType.Directory:
            if self.list_files(uri) and not force:
                raise OSError(f"{uri} is a non-empty directory (use force)")
            self._fs.delete_dir(_path(uri))
        else:
            self._fs.delete_file(_path(uri))
        return True

    def copy(self, src: str, dst: str) -> bool:
        if self.is_directory(src):
            self.mkdir(dst)
            for f in self.list_files(src, recursive=True):
                rel = f[len(_path(src)):].lstrip("/")
                self.copy(f, _path(dst).rstrip("/") + "/" + rel)
            return True
        with self._fs.open_input_stream(_path(src)) as r, \
                self._fs.open_output_stream(_path(dst)) as w:
            w.write(r.read())
        return True

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        if not overwrite and self.exists(dst):
            return False
        self._fs.move(_path(src), _path(dst))
        return True

    def open(self, uri: str) -> BinaryIO:
        import io

        with self._fs.open_input_stream(_path(uri)) as r:
            return io.BytesIO(r.read())

    def copy_to_local(self, src_uri: str, local_path: str) -> None:
        with open(local_path, "wb") as f:
            f.write(self.open(src_uri).read())

    def copy_from_local(self, local_path: str, dst_uri: str) -> None:
        with open(local_path, "rb") as f, \
                self._fs.open_output_stream(_path(dst_uri)) as w:
            w.write(f.read())


register_fs("hdfs", HdfsPinotFS)
