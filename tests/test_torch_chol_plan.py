"""The launch geometry of the Cholesky kernel (ops/chol_inv.plan), the
wrappers' checks and the build key, on the CPU.

The kernel itself runs only on a CUDA device (chip_smoke.py holds it
against the plain version there).  What surrounds it is plain Python: how
many CTAs share an instance, how many instances a wave holds, the shared
memory and the scratch sizes.  A CTA waits on counters that other CTAs
set, so the grid must fit the device at once; the figures below are the
H100's (132 SMs, 232,448 bytes of opt-in shared memory per block).
"""

import shutil

import pytest
import torch

from madipm_tpu_torch.ops import block_chol, chol_inv

H100_SMS = 132
H100_SMEM = 232_448
SIZES = range(32, 4096 + 1, 32)
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp64"])
@pytest.mark.parametrize("B", [1, 2, 8, 16, 600, 70000])
def test_plan_fits_the_device_and_covers_the_batch(B, dtype):
    resident = chol_inv.resident_ctas(dtype, H100_SMS, H100_SMEM)
    assert resident in (H100_SMS, 2 * H100_SMS)
    for N in SIZES:
        nb = N // chol_inv.PANEL
        p = chol_inv.plan(B, N, dtype, H100_SMS, H100_SMEM)
        assert 0 < p.smem_bytes <= H100_SMEM
        assert p.smem_bytes == chol_inv.smem_bytes(dtype)
        assert 1 <= p.ctas_per_instance <= nb
        assert 1 <= p.instances_per_wave <= B
        assert p.grid == p.ctas_per_instance * p.instances_per_wave <= resident
        assert p.waves * p.instances_per_wave >= B
        assert (p.waves - 1) * p.instances_per_wave < B  # no empty wave
        assert p.counter_ints == B * nb > 0
        assert p.tile_elems == B * nb * chol_inv.PANEL ** 2 > 0
        # every block row has exactly one owner in its group, and an owner
        # takes its rows in increasing order (a row waits only on lower rows)
        owners = [0] * nb
        for cta in range(p.ctas_per_instance):
            rows = list(chol_inv.rows_of(cta, p.ctas_per_instance, nb))
            assert rows == sorted(rows)
            for i in rows:
                owners[i] += 1
        assert owners == [1] * nb


def test_plan_uses_the_card_for_the_main_paths_shape():
    """(8, 1024, 1024): a CTA for every block row of every instance, in one
    wave; one small instance alone gets a CTA per block row."""
    for dtype in DTYPES:
        p = chol_inv.plan(8, 1024, dtype, H100_SMS, H100_SMEM)
        assert (p.ctas_per_instance, p.instances_per_wave, p.waves) == (32, 8, 1)
        p = chol_inv.plan(1, 128, dtype, H100_SMS, H100_SMEM)
        assert (p.ctas_per_instance, p.instances_per_wave, p.waves) == (4, 1, 1)
        p = chol_inv.plan(600, 128, dtype, H100_SMS, H100_SMEM)
        assert p.ctas_per_instance == 1 and p.waves == 3


def test_plan_is_sized_by_the_device_it_is_given():
    small = chol_inv.plan(8, 1024, torch.float64, 16, H100_SMEM)
    assert small.grid <= chol_inv.resident_ctas(torch.float64, 16, H100_SMEM) == 32
    assert small.waves * small.instances_per_wave >= 8
    # shared memory for one CTA per SM only: half the resident grid
    need = chol_inv.smem_bytes(torch.float64)
    assert chol_inv.resident_ctas(torch.float64, H100_SMS, need) == H100_SMS
    with pytest.raises(ValueError, match="shared memory"):
        chol_inv.plan(8, 1024, torch.float64, H100_SMS, need - 1)


@pytest.mark.parametrize("B, N", [(0, 64), (1, 0), (1, 48), (-1, 32)])
def test_plan_refuses_what_the_kernel_does_not_take(B, N):
    with pytest.raises(ValueError, match="plan"):
        chol_inv.plan(B, N, torch.float32, H100_SMS, H100_SMEM)


def test_smem_bytes_match_the_source():
    """The figures the kernel's source states (struct Geo): 4 warps, a
    two-stage ring of 128-byte rows padded by 4 elements, three 32 x 36
    tiles."""
    assert chol_inv.smem_bytes(torch.float32) == (4 * 2 * 2 * 32 * 36 + 3 * 32 * 36) * 4
    assert chol_inv.smem_bytes(torch.float64) == (4 * 2 * 2 * 32 * 20 + 3 * 32 * 36) * 8
    src = (chol_inv._CSRC / "chol_inv.cu").read_text()
    for line in ("constexpr int WARPS = 4;", "constexpr int CTAS_PER_SM = 2;",
                 "WARPS * WARP_ELEMS + 3 * NB * LDT"):
        assert line in src


@pytest.mark.parametrize("name", ["chol_inv", "cholesky"])
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    calls = []
    real = getattr(block_chol, name)
    monkeypatch.setattr(block_chol, name, lambda S: (calls.append(S.shape), real(S))[1])
    monkeypatch.setattr(chol_inv, "_load", lambda: pytest.fail("a CPU tensor reached the kernel"))
    before = (chol_inv.launches, chol_inv.cholesky_launches)
    S = 4.0 * torch.eye(64, dtype=torch.float64).expand(2, 64, 64).contiguous()
    out = getattr(chol_inv, name)(S)
    L = out[0] if name == "chol_inv" else out
    torch.testing.assert_close(L, 2.0 * torch.eye(64, dtype=torch.float64).expand(2, 64, 64))
    assert calls == [(2, 64, 64)]
    assert (chol_inv.launches, chol_inv.cholesky_launches) == before


@pytest.mark.parametrize("make, error, match", [
    (lambda: torch.zeros(64, 64, dtype=torch.float16), TypeError, "dtype"),
    (lambda: torch.zeros(64, 64, dtype=torch.int32), TypeError, "dtype"),
    (lambda: torch.zeros(64), ValueError, r"\(N,N\) or \(B,N,N\)"),
    (lambda: torch.zeros(2, 64, 32), ValueError, r"\(N,N\) or \(B,N,N\)"),
    (lambda: torch.zeros(2, 2, 64, 64), ValueError, r"\(N,N\) or \(B,N,N\)"),
    (lambda: torch.zeros(48, 48), ValueError, "multiple of 32"),
    (lambda: torch.zeros(0, 0), ValueError, "multiple of 32"),
    (lambda: torch.zeros(0, 64, 64), ValueError, "empty batch"),
    (lambda: torch.zeros(64, 128)[:, ::2], ValueError, "contiguous"),
    (lambda: torch.zeros(64, 64), ValueError, "device"),
], ids=["fp16", "int32", "vector", "not-square", "4d", "N=48", "N=0", "B=0", "strided", "cpu"])
def test_stack_for_kernel_raises(make, error, match):
    """The checks a tensor passes before it may reach the kernel; the
    device comes last, so a CPU tensor reaches the others."""
    with pytest.raises(error, match=match):
        chol_inv._stack_for_kernel(make(), "chol_inv")


@pytest.mark.parametrize("name", ["chol_inv", "cholesky"])
def test_another_device_raises_instead_of_falling_back(name):
    fn = getattr(chol_inv, name)
    with pytest.raises(ValueError, match="device"):
        fn(torch.empty(64, 64, device="meta"))
    with pytest.raises(TypeError, match="dtype"):
        fn(torch.empty(64, 64, device="meta", dtype=torch.float16))
    with pytest.raises(ValueError, match="multiple of 32"):
        fn(torch.empty(2, 40, 40, device="meta"))


def test_build_key_follows_every_source_file(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(chol_inv._CSRC, csrc)
    monkeypatch.setattr(chol_inv, "_CSRC", csrc)
    key = chol_inv._build_key()
    assert key == chol_inv._build_key()  # stable
    cu = csrc / "chol_inv.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    edited = chol_inv._build_key()
    assert edited != key
    (csrc / "extra.cuh").write_text("// a header the kernel may include\n")
    with_header = chol_inv._build_key()
    assert with_header not in (key, edited)
    (csrc / "extra.cuh").write_text("// changed\n")
    assert chol_inv._build_key() not in (key, edited, with_header)
    (csrc / "second.cu").write_text("// a second translation unit\n")
    sources, files = chol_inv._sources()
    assert [p.name for p in sources] == ["chol_inv.cu", "second.cu"]
    assert {p.name for p in files} == {"chol_inv.cu", "extra.cuh", "second.cu"}
    monkeypatch.setattr(chol_inv, "_NVCC_FLAGS", chol_inv._NVCC_FLAGS + ("-lineinfo",))
    assert chol_inv._build_key() not in (key, edited, with_header)
