"""The port's kernel build helper (cmpc_tpu_torch.ops.cuda_build): what the
library's name is keyed by, and the reading of ptxas' resource report.
Neither needs nvcc; the build itself runs on the card only
(test_torch_cuda.py, chip_smoke.py)."""

import pytest

from cmpc_tpu_torch.ops import cuda_build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN9chol_tile11tile_kernelIdLb1EEEvPKT_xxPS1_xxS4_xxi' for 'sm_90a'
ptxas info    : Function properties for _ZN9chol_tile11tile_kernelIdLb1EEEvPKT_xxPS1_xxS4_xxi
    40 bytes stack frame, 36 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 255 registers, used 2 barriers, 40 bytes cumulative stack size
ptxas info    : Compile time = 900.000 ms
ptxas info    : Compiling entry function '_ZN9chol_tile11tile_kernelIfLb1EEEvPKT_xxPS1_xxS4_xxi' for 'sm_90a'
ptxas info    : Function properties for _ZN9chol_tile11tile_kernelIfLb1EEEvPKT_xxPS1_xxS4_xxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 2 barriers, 16 bytes smem
"""


def test_parse_resource_usage():
    f64, f32 = cuda_build.parse_resource_usage(PTXAS_LOG)
    assert "IdLb1" in f64["entry"] and "IfLb1" in f32["entry"]
    assert (f64["registers"], f64["stack_bytes"], f64["spill_bytes"],
            f64["static_smem_bytes"]) == (255, 40, 80, 0)
    assert (f32["registers"], f32["stack_bytes"], f32["spill_bytes"],
            f32["static_smem_bytes"]) == (128, 0, 0, 16)
    assert cuda_build.parse_resource_usage("") == []


def test_resource_usage_reads_the_report_beside_the_library(tmp_path,
                                                            monkeypatch):
    """The ptxas report lies beside the library under the same hash, so a
    library that is found built still has its spills checked."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    assert cuda_build.resource_usage("chol_tile") == []
    so = cuda_build._library_path("chol_tile")
    assert so.parent == tmp_path and so.suffix == ".so"
    so.with_suffix(".log").write_text(PTXAS_LOG)
    assert [u["spill_bytes"] for u in
            cuda_build.resource_usage("chol_tile")] == [80, 0]
    assert cuda_build.resource_usage("chol_inv_tile") == []


@pytest.mark.parametrize("edited", ["chol_tile.cu", "chol_tile_common.cuh",
                                    "flags"])
def test_digest_covers_source_headers_and_flags(edited, tmp_path,
                                                monkeypatch):
    """An edit to the source, to a header beside it or to the flags gives
    the library another name, so it is rebuilt; an edit to another kernel's
    source does not."""
    for f in cuda_build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    src = tmp_path / "chol_tile.cu"
    flags = cuda_build.NVCC_FLAGS
    before = cuda_build._digest(src, flags)
    assert before == cuda_build._digest(src, flags)
    (tmp_path / "chol_inv_tile.cu").write_text("// another kernel\n")
    assert cuda_build._digest(src, flags) == before
    if edited == "flags":
        flags = flags + ("-lineinfo",)
    else:
        with open(tmp_path / edited, "a") as f:
            f.write("// edited\n")
    assert cuda_build._digest(src, flags) != before


def test_both_kernels_share_the_header():
    """The elimination lives in one header that both sources include, so
    the factor-only kernel's L is the fused kernel's by construction."""
    for name in ("chol_inv_tile", "chol_tile"):
        text = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert '#include "chol_tile_common.cuh"' in text
        assert "__global__" not in text
    assert "-Xptxas" in cuda_build.NVCC_FLAGS
    assert "-use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)
