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


def test_each_row_update_launcher_is_in_the_source_its_wrapper_calls():
    """The row update's eight launchers are split over four sources that
    include ``embedding_update.cuh`` (two row kinds a source, compiled at
    once): each is defined in exactly the source that
    ``kernels.embedding_update.SOURCE`` names, and each source builds its own
    library."""
    import re
    from repro_torch.kernels import embedding_update as eu
    defined = {}
    for src in sorted(build.CSRC.glob("embedding_update*.cu")):
        text = src.read_text()
        assert '#include "embedding_update.cuh"' in text
        for name in re.findall(r'(?:extern "C" int |LAUNCHER\()(embedding_update_\w+)', text):
            defined.setdefault(name, []).append(src.stem)
    assert {k: v for k, v in defined.items() if k in eu.SOURCE} == {
        k: [v] for k, v in eu.SOURCE.items()}
    assert len(set(eu.SOURCE.values())) == 4
    assert set(eu.SOURCE.values()) <= set(_names(build.CSRC))
