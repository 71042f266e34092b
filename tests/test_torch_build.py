"""The kernel build's cache key (``ops/_cuda_build.library_path``): a
library is reused only while its source, every shared header under
``csrc/`` and the compiler flags are unchanged. Nothing is compiled here."""

import pytest

from mvrecon_tpu_torch.ops import _cuda_build as cb


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "syrk_acc.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    monkeypatch.setattr(cb, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", ["source", "header", "new header", "flags"])
def test_library_path_follows_sources_headers_and_flags(csrc, monkeypatch, edit):
    before = cb.library_path("syrk_acc")
    assert before == cb.library_path("syrk_acc")
    assert before.parent == cb.BUILD_DIR and before.name.startswith("libsyrk_acc-")
    if edit == "source":
        (csrc / "syrk_acc.cu").write_text('#include "hopper.cuh"\n// edited\n')
    elif edit == "header":
        (csrc / "hopper.cuh").write_text("// v2\n")
    elif edit == "new header":
        (csrc / "more.cuh").write_text("// new\n")
    else:
        monkeypatch.setattr(cb, "NVCC_FLAGS", cb.NVCC_FLAGS + ("-lineinfo",))
    assert cb.library_path("syrk_acc") != before


def test_library_path_ignores_other_files(csrc):
    before = cb.library_path("syrk_acc")
    (csrc / "notes.txt").write_text("not a build input\n")
    (csrc / "syrk_lower.cu").write_text("// another kernel's source\n")
    assert cb.library_path("syrk_acc") == before


def test_build_directory_is_ignored_by_git():
    root = cb.BUILD_DIR.parents[1]
    assert cb.BUILD_DIR == root / "build" / "kernels"
    assert "build/" in (root / ".gitignore").read_text().split()
