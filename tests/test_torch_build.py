"""The port's kernel builder: what keys a built library (no nvcc needed)."""

import importlib

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build


def test_an_edited_header_changes_the_build_key(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "inc").mkdir()
    header = tmp_path / "inc" / "shared.cuh"
    nested = tmp_path / "inc" / "nested.cuh"
    source = tmp_path / "csrc" / "kernel.cu"
    nested.write_text("// nested\n")
    header.write_text('#pragma once\n#include "nested.cuh"\n')
    # an angle include is not followed; a quoted one is, once, however it is spaced
    source.write_text(
        '#include <cuda.h>\n#include "../inc/shared.cuh"\n  # include "../inc/shared.cuh"\n'
    )
    assert _build.sources(source) == [source.resolve(), header.resolve(), nested.resolve()]
    before = _build.tag(source)
    assert _build.tag(source) == before
    nested.write_text("// nested, edited\n")
    assert _build.tag(source) != before


def test_both_kernels_include_the_shared_hopper_header():
    shared = (_build.BUILD_DIR.parent / "csrc" / "hopper.cuh").resolve()
    for module in ("similarity.similarity", "attention.flash"):
        source = importlib.import_module(f"repro_torch.kernels.{module}").SOURCE
        assert shared in _build.sources(source)


def test_k1_and_k4_run_one_shared_main_loop():
    """The 3xTF32 main loop (TMA ring, producer, promoted wgmma products) lives in
    kernels/csrc/tf32.cuh alone: K1 and K4 include it and issue no wgmma of their own."""
    shared = (_build.BUILD_DIR.parent / "csrc" / "tf32.cuh").resolve()
    assert "tf32x3_tile" in shared.read_text()
    for module in ("similarity.similarity", "gemm.gemm"):
        source = importlib.import_module(f"repro_torch.kernels.{module}").SOURCE
        assert shared in _build.sources(source)
        text = source.read_text()
        assert "tf32x3_tile<" in text
        for own in ("mma_tf32(", "tma_load(", "mbar_init(", "encode(map"):
            assert own not in text, f"{source.name} has its own {own}"
