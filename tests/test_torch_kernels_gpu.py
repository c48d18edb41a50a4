"""The port's CUDA kernels vs their plain PyTorch versions on the card, at
the serving slice's shapes (the checks of chip_smoke.py phase 3) and at
the small geometry of the JAX kernel tests (dim_head 16, S = 32).

Needs an NVIDIA GPU with nvcc: marked `gpu`, and skipped (inside the
fixture, not at import) where torch sees no CUDA device. Run on the card:
    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu
"""
import pytest
import torch

from istvt_tpu_torch.kernels import quant, selfcheck

pytestmark = pytest.mark.gpu

KERNELS = ["ln_qkv_q8_temporal_attention",
           "mm_q8_ln_qkv_q8_spatial_attention",
           "matmul_q8_res_ln_ff_q8_full"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["SLICE", "SMALL"])
def cases(cuda, request):
    return selfcheck.slice_cases(cuda, getattr(selfcheck, request.param))


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_f32_matches_plain(cases, name):
    kern, plain, make = cases[name]
    args = make(torch.float32)
    before = quant.launch_counts[name]
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert quant.launch_counts[name] == before + 1
    ok, err = selfcheck.f32_close(got, want)
    assert ok, f"max|diff| {err}"


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_bf16_matches_plain(cases, name):
    kern, plain, make = cases[name]
    args = make(torch.bfloat16)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    ok, rel, mx, scale = selfcheck.bf16_close(got, want)
    assert ok, (rel, mx, scale)


def test_f8_cast_same_on_card_and_cpu(cuda):
    """The f8 stem store rounds the same on the card as on the CPU."""
    x = torch.cat([torch.linspace(-500, 500, 20001),
                   torch.tensor([464.0, -464.0, 0.5 ** 10, 1e-12])])
    for dt in (torch.float32, torch.bfloat16):
        cpu = x.to(dt).to(torch.float8_e4m3fn).float()
        card = x.to(dt).cuda().to(torch.float8_e4m3fn).float().cpu()
        assert torch.equal(cpu.nan_to_num(1e9), card.nan_to_num(1e9))


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    cases = selfcheck.slice_cases(cuda, selfcheck.SMALL)
    kern, _, make = cases["ln_qkv_q8_temporal_attention"]
    x, *rest = make(torch.float32)
    with pytest.raises(TypeError):
        kern(x.half(), *rest)
    with pytest.raises(ValueError):
        kern(x.transpose(1, 2), *rest)
