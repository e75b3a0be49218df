"""fleet.utils file systems (counterpart of ``paddle_tpu/distributed/
fleet/utils/fs.py``; ref: python/paddle/distributed/fleet/utils/fs.py:116
LocalFS, the HDFS client below it).

``LocalFS`` is a full local implementation; ``HDFSClient`` shells out to
the ``hadoop fs`` CLI as the reference does (a configured hadoop client on
``PATH`` or under ``hadoop_home``) and raises at construction, with the
reason, where there is none. No torch: the module is the reference's,
copied.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

__all__ = ["LocalFS", "HDFSClient", "ExecuteError"]


class ExecuteError(RuntimeError):
    pass


class FS:
    def need_upload_download(self) -> bool:
        raise NotImplementedError


class LocalFS(FS):
    """ref: fs.py:116 — local filesystem with the FS interface."""

    def ls_dir(self, fs_path):
        """Returns (dirs, files) directly under ``fs_path``."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for entry in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, entry))
             else files).append(entry)
        return dirs, files

    def list_dirs(self, fs_path) -> List[str]:
        return self.ls_dir(fs_path)[0]

    def is_file(self, fs_path) -> bool:
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path) -> bool:
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path) -> bool:
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        elif self.is_file(fs_path):
            os.remove(fs_path)

    def need_upload_download(self) -> bool:
        return False

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not overwrite and self.is_exist(dst_path):
            raise ExecuteError(f"{dst_path} already exists")
        if test_exists and not self.is_exist(src_path):
            raise ExecuteError(f"{src_path} does not exist")
        shutil.move(src_path, dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise ExecuteError(f"{fs_path} already exists")
            return
        os.makedirs(os.path.dirname(fs_path) or ".", exist_ok=True)
        open(fs_path, "a").close()

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)

    def upload_dir(self, local_dir, dest_dir):
        shutil.copytree(local_dir, dest_dir, dirs_exist_ok=True)

    def cat(self, fs_path=None) -> str:
        with open(fs_path) as f:
            return f.read()


class HDFSClient(FS):
    """ref: fs.py HDFSClient — drives the ``hadoop fs`` CLI. Needs a
    hadoop client installed (same requirement as the reference)."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None,
                 time_out=5 * 60 * 1000, sleep_inter=1000):
        self._hadoop = (
            os.path.join(hadoop_home, "bin", "hadoop") if hadoop_home
            else shutil.which("hadoop")
        )
        if not self._hadoop or not os.path.exists(self._hadoop):
            raise RuntimeError(
                "HDFSClient needs a hadoop client (bin/hadoop); none found "
                f"at {hadoop_home or 'PATH'}. Point hadoop_home at an "
                "installed client, or use LocalFS / a mounted filesystem."
            )
        self._configs = [f"-D{k}={v}" for k, v in (configs or {}).items()]

    def _run(self, *args) -> str:
        cmd = [self._hadoop, "fs", *self._configs, *args]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ExecuteError(
                f"{' '.join(cmd)} failed: {proc.stderr.strip()}"
            )
        return proc.stdout

    def ls_dir(self, fs_path):
        dirs, files = [], []
        for line in self._run("-ls", fs_path).splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def is_exist(self, fs_path) -> bool:
        try:
            self._run("-test", "-e", fs_path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path) -> bool:
        try:
            self._run("-test", "-d", fs_path)
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path) -> bool:
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        self._run("-rm", "-r", "-f", fs_path)

    def need_upload_download(self) -> bool:
        return True

    def upload(self, local_path, fs_path):
        self._run("-put", "-f", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=True):
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        self._run("-mv", src_path, dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise ExecuteError(f"{fs_path} already exists")
            return
        self._run("-touchz", fs_path)

    def cat(self, fs_path=None) -> str:
        return self._run("-cat", fs_path)
