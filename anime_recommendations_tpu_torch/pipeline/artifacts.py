"""Local versioned artifact store.

Counterpart of anime_recommendations_tpu/pipeline/artifacts.py (that module
is not imported: its package imports jax). Same layout and naming contract,
so a store written by either package reads in the other:

    <root>/<safe name>/v<N>/{files..., .metadata.json}

where the safe name replaces every run of characters outside [A-Za-z0-9._-]
with "_". Artifacts are addressed as ``name``, ``name:vN`` or
``name:latest``, carry a metadata dict and a type, and are immutable once
logged.
"""

from __future__ import annotations

import json
import re
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any

_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


def _safe_dirname(name: str) -> str:
    return _SAFE.sub("_", name)


@dataclass(frozen=True)
class ArtifactHandle:
    name: str
    version: int
    dir: Path
    type: str
    metadata: dict[str, Any]

    @property
    def ref(self) -> str:
        return f"{self.name}:v{self.version}"

    def file(self, filename: str | None = None) -> Path:
        """Path of a contained file; with no argument, the single file."""
        if filename is None:
            files = self.files()
            if len(files) != 1:
                raise ValueError(f"{self.ref} holds {len(files)} files; "
                                 f"specify one of {[f.name for f in files]}")
            return files[0]
        path = self.dir / filename
        if not path.exists():
            raise FileNotFoundError(f"{self.ref} has no file {filename!r}")
        return path

    def files(self) -> list[Path]:
        """The contained files, sorted by name."""
        return sorted(p for p in self.dir.iterdir() if p.name != ".metadata.json")


class ArtifactStore:
    """The store under ``root``; reading never creates directories."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def log(self, name: str, files: dict[str, str | Path] | None = None,
            metadata: dict[str, Any] | None = None, type: str = "file",
            description: str = "") -> ArtifactHandle:
        """Create the next version of ``name`` from existing files on disk."""
        art_dir = self.root / _safe_dirname(name)
        art_dir.mkdir(parents=True, exist_ok=True)
        version = self._next_version(art_dir)
        vdir = art_dir / f"v{version}"
        vdir.mkdir()
        for fname, src in (files or {}).items():
            shutil.copy2(src, vdir / fname)
        meta = {"name": name, "version": version, "type": type,
                "description": description, "metadata": metadata or {}}
        (vdir / ".metadata.json").write_text(json.dumps(meta, indent=2, default=str))
        return self._handle(name, version, vdir)

    def log_frame(self, name: str, frame, filename: str | None = None,
                  index: bool = False, **kwargs) -> ArtifactHandle:
        """Write a DataFrame as <filename or name> (.parquet, else CSV) and log it."""
        filename = filename or name
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = self.root / f".tmp_{_safe_dirname(filename)}"
        if filename.endswith(".parquet"):
            frame.to_parquet(tmp, index=index)
        else:
            frame.to_csv(tmp, index=index)
        try:
            return self.log(name, files={filename: tmp}, **kwargs)
        finally:
            tmp.unlink(missing_ok=True)

    def get(self, ref: str) -> ArtifactHandle:
        """Resolve ``name``, ``name:vN`` or ``name:latest``."""
        name, ver = ref.rsplit(":", 1) if ":" in ref else (ref, "latest")
        art_dir = self.root / _safe_dirname(name)
        if not art_dir.is_dir():
            raise FileNotFoundError(f"No artifact named {name!r} in {self.root}")
        if ver == "latest":
            version = self._latest_version(art_dir)
            if version is None:
                raise FileNotFoundError(f"Artifact {name!r} has no versions")
        else:
            if not ver.startswith("v") or not ver[1:].isdigit():
                raise ValueError(f"Bad version {ver!r} (want vN or latest)")
            version = int(ver[1:])
        vdir = art_dir / f"v{version}"
        if not vdir.exists():
            raise FileNotFoundError(f"{name}:v{version} does not exist")
        return self._handle(name, version, vdir)

    def names(self) -> list[str]:
        """Every artifact's name (as logged, not the directory's), from the
        newest version that holds metadata; a directory without any gives
        its own name."""
        if not self.root.is_dir():
            return []
        dirs = [d for d in sorted(self.root.iterdir())
                if d.is_dir() and not d.name.startswith(".") and self._versions(d)]
        return [self._logged_name(d) for d in dirs]

    @classmethod
    def _logged_name(cls, art_dir: Path) -> str:
        for version in reversed(cls._versions(art_dir)):
            try:
                return json.loads((art_dir / f"v{version}" / ".metadata.json").read_text())["name"]
            except (FileNotFoundError, json.JSONDecodeError, KeyError):
                continue
        return art_dir.name

    def exists(self, ref: str) -> bool:
        try:
            self.get(ref)
            return True
        except (FileNotFoundError, ValueError):
            return False

    def versions(self, name: str) -> list[int]:
        art_dir = self.root / _safe_dirname(name)
        return self._versions(art_dir) if art_dir.is_dir() else []

    @staticmethod
    def _versions(art_dir: Path) -> list[int]:
        return sorted(int(p.name[1:]) for p in art_dir.iterdir()
                      if p.is_dir() and p.name[:1] == "v" and p.name[1:].isdigit())

    def _next_version(self, art_dir: Path) -> int:
        latest = self._latest_version(art_dir)
        return 0 if latest is None else latest + 1

    @classmethod
    def _latest_version(cls, art_dir: Path) -> int | None:
        versions = cls._versions(art_dir)
        return versions[-1] if versions else None

    @staticmethod
    def _handle(name: str, version: int, vdir: Path) -> ArtifactHandle:
        meta = json.loads((vdir / ".metadata.json").read_text())
        return ArtifactHandle(name=name, version=version, dir=vdir,
                              type=meta.get("type", "file"),
                              metadata=meta.get("metadata", {}))
