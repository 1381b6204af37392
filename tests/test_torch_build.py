"""The port's kernel build reports (``autodist_tpu_torch.ops._build``).

nvcc and cuobjdump exist only on the machine with the card, so the parsers
are held here to the formats those tools print: ``-Xptxas -v``'s per-kernel
lines and ``cuobjdump --dump-sass``'s function headers and instructions.
"""
import os
import subprocess

from autodist_tpu_torch.ops import _build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelEPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 159 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_dq_kernelIfEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_dq_kernelIfEEvPKT_
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]
"""

SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelEPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0400*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0410*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
        /*0420*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;
		Function : _ZN12_GLOBAL__N_116flash_dq_kernelIfEEvPKT_
        /*0100*/                   FFMA R1, R2, R3, R1 ;
"""


def test_ptxas_report_reads_registers_and_spills_per_kernel(monkeypatch):
    monkeypatch.setitem(_build.build_logs, "lib", PTXAS_LOG)
    report = _build.ptxas_report("lib")
    fwd = next(v for k, v in report.items() if "flash_fwd_bf16_kernel" in k)
    dq = next(v for k, v in report.items() if "flash_dq_kernel" in k)
    assert fwd == {"spill_stores": 0, "spill_loads": 0, "registers": 159}
    assert dq == {"spill_stores": 12, "spill_loads": 16, "registers": 255}
    assert _build.ptxas_report("not-built-here") == {}


def test_ptxas_report_of_a_library_loaded_as_built(monkeypatch, tmp_path):
    """A second build of an unchanged source runs no nvcc and still reports
    the kernels, from the log kept beside the library."""
    csrc, build_dir = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "lib.cu").write_text("// source\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            with open(cmd[cmd.index("-o") + 1], "w") as f:
                f.write("ELF")

        def communicate(self):
            return PTXAS_LOG, None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    _build.build(["lib"])
    assert os.path.exists(_build._lib_path("lib"))
    assert _build.build_seconds["lib"] > 0.0

    def no_nvcc(cmd, **kwargs):
        raise AssertionError("nvcc started for a library already built")

    monkeypatch.setattr(_build.subprocess, "Popen", no_nvcc)
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    _build.build(["lib"])
    assert _build.build_seconds["lib"] == 0.0
    report = _build.ptxas_report("lib")
    assert next(v for k, v in report.items() if "flash_fwd_bf16_kernel" in k) == {
        "spill_stores": 0, "spill_loads": 0, "registers": 159}
    assert len(report) == 2


def test_sass_counts_per_kernel(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: "/bin/cuobjdump")
    monkeypatch.setattr(_build.os.path, "exists", lambda path: True)
    monkeypatch.setattr(_build, "_lib_path", lambda name: f"/lib{name}.so")
    seen = {}

    def fake_run(cmd, **kwargs):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0, stdout=SASS, stderr="")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    counts = _build.sass_counts("lib", "HMMA")
    assert seen["cmd"] == ["/bin/cuobjdump", "--dump-sass", "/liblib.so"]
    assert counts == {"_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelEPK13__nv_bfloat16": 2,
                      "_ZN12_GLOBAL__N_116flash_dq_kernelIfEEvPKT_": 0}
    assert _build.sass_counts("lib", "LDSM") == {
        "_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelEPK13__nv_bfloat16": 1,
        "_ZN12_GLOBAL__N_116flash_dq_kernelIfEEvPKT_": 0}


def test_sass_counts_without_cuobjdump(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    assert _build.sass_counts("flash_attention", "HMMA") is None
