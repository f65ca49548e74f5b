"""The CUDA build cache of the PyTorch port (``repro_torch.kernels.build``).

A library is keyed by a hash of what nvcc reads: its sources and every header
of ``csrc/`` they may include. Computing the key needs no nvcc, so these run
on the CPU, on a copy of ``csrc/``."""

import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import BWD_SOURCES, SOURCES  # noqa: E402
from repro_torch.kernels.mlstm_chunk import BWD_SOURCES as MLSTM_BWD_SOURCES  # noqa: E402
from repro_torch.kernels.mlstm_chunk import SOURCES as MLSTM_SOURCES  # noqa: E402

LIBRARIES = [("flash_attention", SOURCES), ("flash_attention_bwd", BWD_SOURCES),
             ("mlstm_chunk", MLSTM_SOURCES), ("mlstm_chunk_bwd", MLSTM_BWD_SOURCES)]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build.py reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name,sources", LIBRARIES)
def test_editing_a_header_changes_the_library_path(csrc, name, sources):
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ has no header"
    before = build._library_path(name, sources)
    assert build._library_path(name, sources) == before          # stable
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert build._library_path(name, sources) != before


@pytest.mark.parametrize("name,sources", LIBRARIES)
def test_editing_a_source_changes_only_its_library_path(csrc, name, sources):
    paths = {n: build._library_path(n, s) for n, s in LIBRARIES}
    (csrc / sources[0]).write_text((csrc / sources[0]).read_text() + "\n// edited\n")
    for other, other_sources in LIBRARIES:
        moved = build._library_path(other, other_sources) != paths[other]
        assert moved == (other == name), other


@pytest.mark.parametrize("header", ["hopper.cuh", "mlstm_split.cuh"])
def test_editing_a_shared_header_rebuilds_every_library(csrc, header):
    """Both mLSTM sources include mlstm_split.cuh (which includes hopper.cuh),
    so an edit to either header builds all four libraries anew."""
    paths = {n: build._library_path(n, s) for n, s in LIBRARIES}
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    for name, sources in LIBRARIES:
        assert build._library_path(name, sources) != paths[name], name


def test_a_new_header_changes_the_library_path(csrc):
    before = build._library_path(*LIBRARIES[1])
    (csrc / "extra.h").write_text("#pragma once\n")
    assert build._library_path(*LIBRARIES[1]) != before


def test_library_path_lies_in_the_build_directory():
    path = build._library_path(*LIBRARIES[0])
    assert path.parent == build.BUILD_DIR and path.name.startswith("libflash_attention-")
    assert path.suffix == ".so"
