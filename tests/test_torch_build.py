"""The kernel build's cache key: a library is named by a hash of the
flags and of every source file the build reads, so editing a kernel's
``.cu`` or any header beside it gives a new library name (a stale one is
never loaded). Nothing here compiles: ``_target`` only hashes."""

import shutil

import pytest

from repro_torch.kernels import _build


def test_flash_attention_build_reads_its_header():
    names = [p.name for p in _build._inputs("flash_attention")]
    assert names == ["flash_attention.cu", "flash_attention_wgmma.cuh"]


def test_sample_clock_build_reads_its_source():
    assert [p.name for p in _build._inputs("sample_clock")] == [
        "sample_clock.cu"]
    assert _build._source("sample_clock").is_file()


def test_trace_sensor_build_reads_the_shared_lookup_header():
    """trace_sensor includes count_le's lookup header from that kernel's
    directory: the header is one of its inputs."""
    assert [p.name for p in _build._inputs("trace_sensor")] == [
        "trace_sensor.cu", "count_le.cuh"]
    assert [p.name for p in _build._inputs("count_le")] == [
        "count_le.cu", "count_le.cuh"]


@pytest.fixture
def kernels_copy(tmp_path, monkeypatch):
    """A copy of the kernels' sources, so that edits touch no real file."""
    for name in ("flash_attention", "rmsnorm", "sample_attr", "sample_clock",
                 "count_le", "trace_sensor"):
        src = _build._KERNELS_DIR / name
        dst = tmp_path / name
        dst.mkdir()
        for p in src.iterdir():
            if p.suffix in (".cu", ".cuh", ".py"):
                shutil.copy(p, dst / p.name)
    monkeypatch.setattr(_build, "_KERNELS_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("name,edited", [
    ("flash_attention", "flash_attention.cu"),
    ("flash_attention", "flash_attention_wgmma.cuh"),
    ("flash_attention", "new_header.cuh"),
    ("rmsnorm", "rmsnorm.cu"),
    ("sample_attr", "sample_attr.cu"),
    ("sample_clock", "sample_clock.cu"),
    ("trace_sensor", "trace_sensor.cu"),
    ("trace_sensor", "../count_le/count_le.cuh"),
    ("count_le", "count_le.cuh")])
def test_any_source_edit_renames_the_library(kernels_copy, name, edited):
    before = _build._target(name)
    path = kernels_copy / name / edited
    path.write_text((path.read_text() if path.exists() else "") + "\n// x\n")
    after = _build._target(name)
    assert after != before and after.parent == before.parent


def test_other_files_and_other_kernels_keep_the_name(kernels_copy):
    before = {n: _build._target(n) for n in ("flash_attention", "rmsnorm")}
    (kernels_copy / "flash_attention" / "ops.py").write_text("# edited\n")
    (kernels_copy / "rmsnorm" / "notes.txt").write_text("edited\n")
    (kernels_copy / "sample_attr" / "sample_attr.cu").write_text("// x\n")
    assert {n: _build._target(n) for n in before} == before


def test_flags_are_part_of_the_name(monkeypatch):
    before = _build._target("flash_attention")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build._target("flash_attention") != before
