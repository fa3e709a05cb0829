"""The port as an installed package: ``pyproject.toml`` ships the native
BVH builder's source and the parity references and installs the
``mort-tpu-torch`` console script, and ``_build.build_dir`` builds in the
user's cache directory where the package's own build directory cannot be
written (an installed ``site-packages``)."""

import ctypes
import shutil
import sys
import tomllib
from pathlib import Path

import pytest

from mort_tpu_torch import _build, cli

REPO = Path(__file__).resolve().parent.parent


def test_pyproject_ships_the_port():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert cfg["project"]["scripts"]["mort-tpu-torch"] == \
        "mort_tpu_torch.cli:script"
    data = cfg["tool"]["setuptools"]["package-data"]
    assert "*.cpp" in data["mort_tpu_torch.native"]
    assert "data/*.npz" in data["mort_tpu_torch"]
    for pattern in ("native/*.cpp", "data/*.npz", "csrc/*.cu"):
        assert list((REPO / "mort_tpu_torch").glob(pattern)), pattern


def test_console_script_exits_zero(tmp_path, monkeypatch, capsys):
    out = tmp_path / "x.npz"
    monkeypatch.setattr(sys, "argv", [
        "mort-tpu-torch", "render", "5", "--width", "8", "--spp", "1",
        "--depth", "2", "--device", "cpu", "--out", str(out)])
    assert cli.script() == 0
    assert out.exists() and capsys.readouterr().out.strip() == str(out)


@pytest.fixture
def unwritable_build_dir(tmp_path, monkeypatch):
    """BUILD_DIR below a regular file (no directory can be made there) and
    XDG_CACHE_HOME in tmp_path."""
    blocker = tmp_path / "site-packages"
    blocker.write_text("")
    monkeypatch.setattr(_build, "BUILD_DIR",
                        blocker / "build" / "mort_tpu_torch")
    monkeypatch.setattr(_build, "_build_dir", [])
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return tmp_path / "cache" / "mort_tpu_torch" / "build"


def test_build_dir_is_the_cache_when_unwritable(unwritable_build_dir,
                                                capsys):
    assert _build.build_dir() == unwritable_build_dir
    assert str(unwritable_build_dir) in capsys.readouterr().err
    assert _build.build_dir() == unwritable_build_dir   # decided once
    assert capsys.readouterr().err == ""
    assert _build.library_path("closest_hit").parent == unwritable_build_dir


def test_build_dir_is_beside_the_package_when_writable(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "m")
    monkeypatch.setattr(_build, "_build_dir", [])
    assert _build.build_dir() == tmp_path / "build" / "m"


def test_compile_in_the_cache_and_a_failed_compile_raises(
        unwritable_build_dir, tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no C++ compiler"
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe(void) { return 7; }\n')
    lib = _build.compile_library("probe", src, cxx, ("-shared", "-fPIC"))
    assert lib.parent == unwritable_build_dir
    assert ctypes.CDLL(str(lib)).probe() == 7
    bad = tmp_path / "bad.cpp"
    bad.write_text("int probe(void) { return }\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.compile_library("bad", bad, cxx, ("-shared", "-fPIC"))
