"""The port's card scripts, checked on the CPU where they need no card: the
ptxas summary that ``chip_smoke.py`` prints in its build phase, and how
``tools/flash_ab.py`` decides whether two trees must give bitwise equal
outputs."""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

import chip_smoke

REPO = Path(__file__).resolve().parent.parent


def _flash_ab():
    spec = importlib.util.spec_from_file_location("flash_ab", REPO / "tools" / "flash_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(kernel: str, body: str, arg: int) -> str:
    return (f"ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__9d1c1498_15_"
            f"{kernel}_cu_ce9e7404{len(body)}{body}ILi{arg}EEEv14CUtensorMap_stPKf' "
            f"for 'sm_90a'")


def test_ptxas_summary_reports_the_h128_entries():
    log = "\n".join([
        _entry("flash_bwd_dq", "flash_dq_sm90", 1),  # H <= 64: not the summary's
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 150 registers, used 1 barriers",
        _entry("flash_bwd_dq", "flash_dq_sm90", 2),
        "ptxas info    : Function properties for flash_dq_sm90",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        _entry("flash_bwd_dq", "flash_dq_f32", 8),
        "    56 bytes stack frame, 100 bytes spill stores, 104 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 56 bytes cumulative stack size",
        _entry("flash_bwd_dq", "flash_dq_bf16", 8),  # no such body any more
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 166 registers, used 1 barriers",
    ])
    assert chip_smoke.ptxas_summary(log) == {
        "flash_dq_sm90": {"spill_stores": 0, "spill_loads": 0, "registers": 168},
        "flash_dq_f32": {"spill_stores": 100, "spill_loads": 104, "registers": 255},
    }


def _tree(root: Path, files: dict) -> Path:
    csrc = root / "tputopo_torch" / "csrc"
    csrc.mkdir(parents=True)
    for name, text in files.items():
        (csrc / name).write_text(text)
    return csrc / "flash_bwd_dq.cu"


@pytest.mark.parametrize("other_files,same", [
    ({"flash_bwd_dq.cu": "body", "sm90.cuh": "h1", "flash_common.cuh": "h2"}, True),
    ({"flash_bwd_dq.cu": "new body", "sm90.cuh": "h1", "flash_common.cuh": "h2"}, False),
    ({"flash_bwd_dq.cu": "body", "sm90.cuh": "h1 changed", "flash_common.cuh": "h2"}, False),
    ({"flash_bwd_dq.cu": "body", "sm90.cuh": "h1"}, False),  # a header missing
    ({"flash_bwd_dq.cu": "body", "sm90.cuh": "h1", "flash_common.cuh": "h2",
      "extra.cuh": "h3"}, False),
    # another kernel's source is not the one compared
    ({"flash_bwd_dq.cu": "body", "sm90.cuh": "h1", "flash_common.cuh": "h2",
      "flash_fwd.cu": "other kernel"}, True),
], ids=["identical", "source", "header", "missing-header", "extra-header", "other-kernel"])
def test_flash_ab_asks_bitwise_equality_only_of_identical_sources(tmp_path, other_files,
                                                                  same):
    flash_ab = _flash_ab()
    this = _tree(tmp_path / "this",
                 {"flash_bwd_dq.cu": "body", "sm90.cuh": "h1", "flash_common.cuh": "h2"})
    other = _tree(tmp_path / "other", other_files)
    assert flash_ab.same_source(this, other) is same
    assert flash_ab.same_source(other, this) is same
