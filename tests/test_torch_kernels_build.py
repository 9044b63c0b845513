"""Building the port's CUDA kernels (tntblast_tpu_torch._kernels), its
reading of the compiler's report, and the inputs of the kernel checks
(tools/bench_inputs.py, tools/dp_steps.py), without a compiler: nvcc is
replaced by a stub that writes the output file."""

import os
import re
import time

import numpy as np
import pytest
import torch

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch.tools import bench_inputs, dp_steps


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    """A csrc/ with one kernel and one header, a _build/ beside it, and a
    stub compiler that records its command lines."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("#include \"core.cuh\"\n")
    (csrc / "core.cuh").write_text("// core\n")
    calls = []

    class Done:
        returncode, stdout, stderr = 0, "", "ptxas info    : fine\n"

    def run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as fh:
            fh.write("lib")
        return Done()

    monkeypatch.setattr(_kernels, "CSRC", str(csrc))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "run", run)
    return csrc, calls


def _age(path, seconds):
    t = time.time() - seconds
    os.utime(path, (t, t))


def test_build_rebuilds_when_a_header_is_newer(fake_tree):
    csrc, calls = fake_tree
    for f in csrc.iterdir():
        _age(f, 100)
    lib = _kernels.build("k")
    assert len(calls) == 1 and os.path.exists(lib)
    assert _kernels.build_log["k"] == "ptxas info    : fine\n"
    assert _kernels.build("k") == lib and len(calls) == 1     # up to date
    _age(lib, 50)
    _age(csrc / "core.cuh", 10)           # the header alone is newer
    assert _kernels.sources_mtime() == os.path.getmtime(csrc / "core.cuh")
    assert _kernels.build("k") == lib and len(calls) == 2
    assert _kernels.build("k", force=True) == lib and len(calls) == 3


def test_build_variant_gets_flags_and_its_own_library(fake_tree):
    _, calls = fake_tree
    lib = _kernels.build("k")
    var = _kernels.build("k", flags=["-DX=1"], tag="_x")
    assert var != lib and var.endswith("libk_x.so")
    assert "-DX=1" in calls[-1] and "-DX=1" not in calls[0]
    assert "k_x" in _kernels.build_log
    for cmd in calls:
        assert "arch=compute_90a,code=sm_90a" in cmd


def test_eval_pack_is_built_without_contraction(fake_tree):
    """eval_pack's f32 sums are held against the plain version bit for bit:
    every build of it, and of it alone, gets -fmad=false."""
    csrc, calls = fake_tree
    (csrc / "eval_pack.cu").write_text("// kernel\n")
    _kernels.build("eval_pack")
    _kernels.build("k")
    _kernels.build("eval_pack", flags=["-DX=1"], tag="_x")
    assert "-fmad=false" in calls[0] and "-fmad=false" in calls[2]
    assert "-fmad=false" not in calls[1]
    assert not any("fast" in arg for cmd in calls for arg in cmd)


def test_eval_pack_source_has_a_plain_c_entry_and_a_host_build():
    with open(os.path.join(_kernels.CSRC, "eval_pack.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int eval_pack_launch_plan(' in src
    assert "#ifdef EVAL_PACK_HOST" in src and "<<<" in src
    # one path: the host build is the source's only build switch
    assert set(re.findall(r"#\s*if(?:n?def)?\s+(\w+)", src)) == {
        "EVAL_PACK_HOST"}
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>",
                        '#include "staging.cuh"']
    with open(os.path.join(_kernels.CSRC, "staging.cuh")) as fh:
        includes = [ln for ln in fh.read().splitlines()
                    if ln.startswith("#include")]
    # nothing the host build's shim does not stand in for
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>"]


def test_real_sources_share_the_core_header():
    names = set(os.listdir(_kernels.CSRC))
    assert {"dp_core.cuh", "screen_dp.cu", "screen_probe.cu"} <= names
    for name in ("screen_dp.cu", "screen_probe.cu"):
        with open(os.path.join(_kernels.CSRC, name)) as fh:
            src = fh.read()
        assert '#include "dp_core.cuh"' in src
        assert "dp_row<" in src           # the shared cell code, not a copy
    assert _kernels.sources_mtime() >= os.path.getmtime(
        os.path.join(_kernels.CSRC, "dp_core.cuh"))
    # the span walk of the staged M rows is one piece of code: screen_dp
    # stores through it (via dp_core.cuh), eval_pack loads through it
    srcs = {}
    for name in names:
        with open(os.path.join(_kernels.CSRC, name)) as fh:
            srcs[name] = fh.read()
    assert [n for n, t in srcs.items() if "struct SpanIndex" in t] == [
        "staging.cuh"]
    assert '#include "staging.cuh"' in srcs["dp_core.cuh"]
    for name in ("screen_dp.cu", "eval_pack.cu"):
        assert "SpanIndex at(lane, w1)" in srcs[name]


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z16screen_dp_kernelILi32ELb0EEv6DpArgs' for 'sm_90a'
ptxas info    : Function properties for _Z16screen_dp_kernelILi32ELb0EEv6DpArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z16screen_dp_kernelILi32ELb1EEv6DpArgs' for 'sm_90a'
ptxas info    : Function properties for _Z16screen_dp_kernelILi32ELb1EEv6DpArgs
    56 bytes stack frame, 52 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z21screen_dp_wide_kernelILb1EEv6DpArgs' for 'sm_90a'
ptxas info    : Function properties for _Z21screen_dp_wide_kernelILb1EEv6DpArgs
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
"""


def test_ptxas_problems_flags_register_kernels_only():
    bad = _kernels.ptxas_problems(PTXAS_LOG)
    assert [k for k, _ in bad] == ["_Z16screen_dp_kernelILi32ELb1EEv6DpArgs"]
    assert "56 bytes stack frame" in bad[0][1]
    clean = PTXAS_LOG.replace("56 bytes stack frame, 52 bytes spill stores, "
                              "52 bytes spill loads",
                              "0 bytes stack frame, 0 bytes spill stores, "
                              "0 bytes spill loads")
    assert _kernels.ptxas_problems(clean) == []
    lines = _kernels.ptxas_summary(PTXAS_LOG, "Li32ELb0E")
    assert len(lines) == 1 and "Used 168 registers" in lines[0]
    assert "0 bytes stack frame" in lines[0]


@pytest.mark.parametrize("slot_major", [False, True])
def test_chunk_inputs_feed_the_plain_version(slot_major):
    """The timing tools' synthetic chunk is a valid screen_dp call: shapes,
    ranges, invalid entries outside the slots, sorted when slot-major."""
    from tntblast_tpu_torch.ops.screen_dp import screen_dp

    rng = np.random.default_rng(3)
    qp = torch.from_numpy(rng.integers(0, 30, (5, 10)).astype(np.int32))
    tcan = torch.from_numpy(
        rng.integers(-500, 500, (2, 30, 30, 7)).astype(np.int32))
    ql_slot = np.array([10, 8, 9, 10, 4], np.int32)
    args, slot, ql = bench_inputs.chunk_inputs(
        rng, 300, qp, ql_slot, tcan, "cpu", invalid=0.2,
        slot_major=slot_major)
    ptb, slot_t, ql_t, wt_e = args[:4]
    assert ptb.shape == (300, 18) and ptb.dtype == torch.int32
    assert int(ptb.min()) >= 0 and int(ptb.max()) < 30
    assert ((slot == 5).sum() > 20) and slot.max() == 5
    assert (np.diff(slot) >= 0).all() == slot_major
    valid = slot < 5
    assert (ql[valid] == ql_slot[slot[valid]]).all()
    assert torch.equal(wt_e, ql_t + 8)
    best, mgmax, rows = screen_dp(*args, eval_on=True)
    assert (best[:, torch.from_numpy(~valid)] == -1).all()
    assert rows.shape == (10, 300, 19)
    assert bench_inputs.dp_errors((best, mgmax, rows), (best, mgmax, rows),
                              args, True) == [0, 0, 0]


SASS = """\
	Function : _Z16screen_dp_kernelILi32ELb0EEv6DpArgs
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 BRA 0x60 ;
        /*0020*/                   LDS R4, [R2+0x80] ;
        /*0030*/                   VIADDMNMX R5, R4, R6, R7, !PT ;
        /*0040*/                   VIMNMX.RELU R8, R5, R9, !PT ;
        /*0050*/               @P1 BRA 0x20 ;
        /*0060*/                   LDS R4, [R2] ;
        /*0070*/                   IMAD.IADD R3, R3, 0x1, R4 ;
        /*0080*/                   ISETP.GE.AND P0, PT, R3, R10, PT ;
        /*0090*/                   VIADDMNMX.RELU R5, R4, R6, R7, !PT ;
        /*00a0*/                   LDS R4, [R2+0x100] ;
        /*00b0*/              @!P0 BRA 0x60 ;
        /*00c0*/                   EXIT ;
	Function : _Z21screen_dp_wide_kernelILb0EEv6DpArgs
        /*0000*/                   EXIT ;
"""


def test_parse_sass_counts_the_longest_loop():
    mix = dp_steps.parse_sass(SASS, "Li32E")
    assert list(mix) == ["_Z16screen_dp_kernelILi32ELb0EEv6DpArgs"]
    got = mix["_Z16screen_dp_kernelILi32ELb0EEv6DpArgs"]
    # the loop 0x60..0xb0 (6 instructions), not the shorter 0x20..0x50
    assert got["kernel_total"] == 13 and got["row_loop_total"] == 6
    assert (got["LDS"], got["VIADDMNMX"], got["IMAD"], got["ISETP"]) == (
        2, 1, 1, 1)
    assert got["VIMNMX"] == 0
