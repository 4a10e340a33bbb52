"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test takes the ``cuda`` fixture, which skips when no
CUDA device is present.  Run them on the H100 with
``python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest``
(``tests/conftest.py`` sets up JAX, which the port does not need).

Tolerances: the qmm kernel decodes the same bf16 weights as the plain
version and accumulates in f32 in another order, so outputs differ by at
most one bf16 ulp of the output plus f32 reassociation: rtol 1e-2, atol
2e-2.  The decode kernel rounds probabilities to bf16 against chunk-wise
running maxima, so each probability may land one ulp (2^-8 relative)
apart and an output element moves by up to 2^-8 of the attended values'
scale, even where it cancels to near 0: each element within 2e-2 of its
(row, head)'s largest |output|.  The planted cases make one key read too
many or too few at a window edge move the output by O(1).  Caches
byte-equal."""

import pytest
import torch

from chip_smoke import plant_edges
from qlora_tpu_torch.generate import generate
from qlora_tpu_torch.models import forward, get_config, init_params
from qlora_tpu_torch.ops import decode_attention_cuda, decode_attention_plain
from qlora_tpu_torch.ops import qmatmul, qmatmul_plain, qmm_nf4_fwd_dq, qmm_nf4_fwd_f32
from qlora_tpu_torch.quant import quantize
from qlora_tpu_torch.utils import move_to

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("M,K,N,block_size", [
    (1, 256, 64, 64), (4, 4096, 4096, 64), (37, 384, 200, 64),
    (300, 1024, 320, 32), (2048, 11008, 512, 64), (16, 64 * 600, 96, 64),
])
@pytest.mark.parametrize("double_quant", [True, False])
def test_qmm_kernel_matches_plain(cuda, M, K, N, block_size, double_quant):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, device=cuda, generator=g) * K ** -0.5
    qt = quantize(w, block_size=block_size, double_quant=double_quant)
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    wrapper = qmm_nf4_fwd_dq if double_quant else qmm_nf4_fwd_f32
    before = wrapper.launches
    y = qmatmul(x, qt)
    assert wrapper.launches == before + 1
    torch.testing.assert_close(y.float(), qmatmul_plain(x, qt).float(), rtol=1e-2, atol=2e-2)


def test_qmm_rejects_bad_input(cuda):
    qt = quantize(torch.randn(256, 64, device=cuda))
    with pytest.raises(ValueError):
        qmm_nf4_fwd_dq(torch.zeros(4, 128, device=cuda, dtype=torch.bfloat16), qt)
    with pytest.raises(ValueError):
        qmm_nf4_fwd_f32(torch.zeros(4, 256, device=cuda, dtype=torch.bfloat16), qt)


@pytest.mark.parametrize("B,H,KVH,hd,T,lens,window,planted", [
    (4, 32, 32, 128, 640, [0, 97, 383, 639], None, False),
    (2, 32, 8, 128, 300, [5, 299], 256, False),
    (3, 8, 2, 64, 130, [0, 129, 130], None, False),     # 130 == T: no write
    (2, 64, 2, 256, 70, [69, 3], 16, False),            # G = 32
    (4, 32, 8, 128, 640, [0, 97, 383, 639], 256, True),
    (3, 8, 2, 64, 130, [1, 64, 129], None, True),
])
def test_decode_kernel_matches_plain(cuda, B, H, KVH, hd, T, lens, window, planted):
    g = torch.Generator(device=cuda).manual_seed(T)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g).to(torch.bfloat16)
    q, nk, nv, kc, vc = mk(B, H, hd), mk(B, KVH, hd), mk(B, KVH, hd), \
        mk(B, KVH, T, hd), mk(B, KVH, T, hd)
    if planted:
        plant_edges(q, kc, lens, window)
    L = torch.tensor(lens, device=cuda, dtype=torch.int32)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = decode_attention_cuda.launches
    o1, _, _ = decode_attention_cuda(q, nk, nv, k1, v1, L, sm_scale=hd ** -0.5,
                                     sliding_window=window)
    o2, _, _ = decode_attention_plain(q, nk, nv, k2, v2, L, sm_scale=hd ** -0.5,
                                      sliding_window=window)
    assert decode_attention_cuda.launches == before + 1
    d = (o1.float() - o2.float()).abs()
    tol = 2e-2 * o2.float().abs().amax(-1, keepdim=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max().item()}"
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_debug_model_card_matches_cpu(cuda):
    """The same weights through the kernels and through the plain path:
    logits within atol 0.1 (bf16 activations rounded in other orders, see
    tests/test_torch_model.py)."""
    cfg = get_config("debug")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = move_to(p_cpu, cuda)
    ids = torch.tensor([[3, 17, 5, 9], [4, 7, 0, 0]])
    lengths = torch.tensor([4, 2])
    toks = generate(p_gpu, None, ids, lengths, cfg, max_new_tokens=4, eos_id=-1)
    assert toks.shape == (2, 4) and toks.is_cuda
    with pytest.raises(NotImplementedError, match="flash"):
        forward(p_gpu, None, torch.zeros(1, 128, dtype=torch.long, device=cuda), cfg)
    got, _ = forward(p_gpu, None, ids.to(cuda), cfg, use_flash="never")
    want, _ = forward(p_cpu, None, ids, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0.1)
