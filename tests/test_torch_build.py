"""kernels/build.py names each CUDA library after the hash of its source, of
every header beside it and of the flags: an edited header rebuilds every
library, an edited source only its own.  On the CPU: the names are computed,
nothing is compiled."""

import shutil

import pytest

from repro_torch.kernels import build


def _names(csrc):
    return {src.stem: build._target(src).name for src in sorted(csrc.glob("*.cu"))}


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(build.CSRC, tmp_path / "csrc")


def test_names_follow_the_contents_not_the_place(csrc):
    assert _names(csrc) == _names(build.CSRC)
    assert all(name.startswith(f"lib{stem}_") and name.endswith(".so")
               for stem, name in _names(csrc).items())


@pytest.mark.parametrize("edit", ["append", "new header"])
def test_a_header_edit_renames_every_library(csrc, edit):
    before = _names(csrc)
    assert len(before) >= 2 and any(csrc.glob("*.cuh"))
    if edit == "append":
        header = csrc / "hopper.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _names(csrc)
    assert after.keys() == before.keys()
    assert all(after[stem] != before[stem] for stem in before)


@pytest.mark.parametrize("stem", ["fused_mlp", "flash_attention"])
def test_a_source_edit_renames_only_its_library(csrc, stem):
    before = _names(csrc)
    src = csrc / f"{stem}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _names(csrc)
    assert {s for s in before if after[s] != before[s]} == {stem}


PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_attention_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiififi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_attention_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiififi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 72 bytes smem, 1216 bytes cmem[0]
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12wg22fused_mlp_wgmma_kernelE14CUtensorMap_stS1_PKvPviiiiii' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 90 registers, 64 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel(monkeypatch):
    monkeypatch.setitem(build.build_log, "sample", {"seconds": 1.0, "ptxas": PTXAS})
    assert build.ptxas_report("sample") == [
        {"kernel": "flash_attention_kernel<128>", "spill_stores": 0, "spill_loads": 0,
         "registers": 168, "smem": 72},
        {"warning": "ptxas warning : (C7508) setmaxnreg ignored; unable to determine register "
                    "count at entry"},
        {"kernel": "fused_mlp_wgmma_kernel", "spill_stores": 4, "spill_loads": 8,
         "registers": 90, "smem": 64}]
    assert build.ptxas_report("no such source") == []
