"""The kernel build's cache key and file list, without nvcc.

The library's file name is a hash of every file under ``csrc/``: an edit
to a header that a source includes must build a new library, or a stale
one with the old code would load. Only the ``*.cu`` files are compiled.
"""

import tomllib
from pathlib import Path

import pytest

from radio_mapper_tpu_torch.ops.cuda import build
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return g(); }\n')
    (tmp_path / "shared.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_library_path_follows_headers(csrc):
    before = build.library_path()
    (csrc / "shared.cuh").write_text("inline int g() { return 2; }\n")
    after = build.library_path()
    assert before != after
    (csrc / "shared.cuh").write_text("inline int g() { return 1; }\n")
    assert build.library_path() == before


def test_library_path_follows_sources_and_ignores_other_files(csrc):
    before = build.library_path()
    (csrc / "notes.txt").write_text("not part of the build\n")
    assert build.library_path() == before
    (csrc / "k2.cu").write_text('extern "C" int h() { return 3; }\n')
    assert build.library_path() != before


def test_only_sources_are_compiled(csrc):
    assert [p.name for p in build._sources()] == ["k.cu"]
    assert [p.name for p in build._tree()] == ["k.cu", "shared.cuh"]


def test_no_sources_raises(tmp_path, monkeypatch):
    (tmp_path / "only.cuh").write_text("")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    with pytest.raises(RuntimeError):
        build.library_path()


def test_package_tree_and_package_data_cover_every_file():
    """The shipped package data lists every kind of file under ``csrc/``."""
    root = Path(__file__).resolve().parents[1]
    data = tomllib.loads((root / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["radio_mapper_tpu_torch"]
    shipped = {p for g in globs for p in (root / "radio_mapper_tpu_torch").glob(g)}
    assert set(build._tree()) <= shipped
    assert any(p.suffix == ".cuh" for p in build._tree())
