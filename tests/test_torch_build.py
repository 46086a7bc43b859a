"""The kernel build of the port: a build that cannot run or fails raises and
leaves no library behind (no fallback path), and the build directory follows
the sources. The compiler itself exists only where the card is, so these
tests stand in for it with a missing ``nvcc`` and with ``false``."""
import shutil

import pytest

from repro_torch.kernels import build

pytestmark = pytest.mark.torch_port


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "kernels").exists()


def test_failed_compile_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    out = build.build_dir()
    assert list(out.iterdir()) and not list(out.glob("*.so*"))
    assert set(build.build_logs()) == set(build.SOURCES)


def test_build_dir_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.build_dir()
    assert build.build_dir() == before
    src = csrc / "topk_smallest.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.build_dir() != before
    assert {f"{s}.cu" for s in build.SOURCES} <= {p.name for p in
                                                  csrc.iterdir()}


def test_every_entry_point_has_a_source():
    assert {lib for lib, _ in build.SIGNATURES.values()} == set(build.SOURCES)
    build.check("topk_rank_launch", 0)          # a zero code is no error
