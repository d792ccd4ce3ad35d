"""Host-side choices of the port's flash attention kernels, which the CPU
can check although the kernels run only on the card: the route a type and
head dim take (``flash_attention.route``), the split of the dK/dV pass
over a kv head's group of q heads (``dkdv_parts``), the alignment the
tensor-core route's 16-byte copies need (``check_aligned``), the launch
counts by route in ``ops.LAUNCHES``, and the build's hash over the shared
headers (``_build.library_path``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

H100_SMS = 132


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "mma"),      # TinyLlama, SmolLM, XLM-R, CLIP
    (torch.bfloat16, 128, "mma"),     # Llama-2, CodeQwen, Grok
    (torch.bfloat16, 8, "mma"),
    (torch.bfloat16, 96, "mma"),
    (torch.bfloat16, 256, "simt"),    # Gemma, PaliGemma
    (torch.bfloat16, 60, "simt"),     # rows not a multiple of 16 bytes
    (torch.bfloat16, 136, "simt"),
    (torch.float32, 8, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_route_by_type_and_head_dim(dtype, d, want):
    assert tfa.route(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 0), (torch.bfloat16, 257), (torch.float32, 512),
    (torch.float16, 64), (torch.int32, 64)])
def test_route_raises_on_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="no kernel takes"):
        tfa.route(dtype, d)


def test_routes_match_the_launch_functions_numbering():
    """The C launch functions take route 0 (SIMT) or 1 (tensor cores)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert tfa.ROUTES == ("simt", "mma")
    assert "route 0: SIMT" in src and "route 1: tensor cores" in src


def test_dkdv_split_fills_the_card_at_the_seq128_round():
    """B 4 × S 128, 4 kv heads of 8 q heads: 32 blocks unsplit, so the whole
    group splits, one q head a block: 256 blocks for 132 SMs."""
    parts = tfa.dkdv_parts(4, 4, 128, 8, H100_SMS)
    grid = tfa.dkdv_grid("mma", 4, 4, 128, 64, parts)
    assert parts == 8 and 8 % parts == 0
    assert grid == (128, 2) and int(np.prod(grid)) >= H100_SMS


def test_dkdv_split_at_seq1024_doubles_the_grid():
    """S 1024: 256 blocks unsplit fill the 2 × 132 resident slots only
    once, and the first key block carries 16 times the last one's work; two
    parts give 512 blocks, the heaviest half as heavy."""
    assert tfa.dkdv_parts(4, 4, 1024, 8, H100_SMS) == 2
    assert tfa.dkdv_grid("mma", 4, 4, 1024, 64, 2) == (32, 16)


@pytest.mark.parametrize("B,K,S,group", [
    (4, 4, 128, 8), (32, 4, 128, 8), (4, 4, 1024, 8), (2, 12, 512, 1),
    (1, 1, 64, 12), (1, 2, 200, 6), (3, 1, 130, 16), (1, 1, 8, 7)])
def test_dkdv_parts_divide_the_group_and_are_the_smallest(B, K, S, group):
    parts = tfa.dkdv_parts(B, K, S, group, H100_SMS)
    blocks = B * K * -(-S // tfa.DKDV_BLOCK_K)
    assert group % parts == 0
    assert blocks * parts >= 2 * H100_SMS or parts == group
    assert all(blocks * p < 2 * H100_SMS for p in range(1, parts)
               if group % p == 0)


def test_dkdv_parts_is_one_when_the_grid_is_large():
    assert tfa.dkdv_parts(2, 12, 512, 1, H100_SMS) == 1     # XLM-R
    assert tfa.dkdv_parts(8, 4, 2048, 8, H100_SMS) == 1


def test_dkdv_grid_of_the_simt_route():
    assert tfa.dkdv_grid("simt", 2, 16, 512, 256) == (16, 16, 2)
    assert tfa.dkdv_grid("simt", 4, 4, 1024, 64) == (16, 4, 4)


def _model_layout_view(B, S, H, D):
    """Shape and strides of a (B,H,S,D) view of (B,S,H,D) memory."""
    t = torch.empty((B, S, H, D)).transpose(1, 2)
    return t.shape, t.stride()


def test_alignment_accepts_the_models_projection_slices():
    shape, strides = _model_layout_view(4, 1024, 32, 64)
    tfa.check_aligned("q", shape, strides, 0x7f0000000000)
    # k and v: slices of one (B, S, 2·K·D) projection
    kv = torch.empty((4, 1024, 2 * 4 * 64))
    v = kv[..., 4 * 64:].reshape(4, 1024, 4, 64).transpose(1, 2)
    tfa.check_aligned("v", v.shape, v.stride(), 0x7f0000000000 + 4 * 64 * 2)


@pytest.mark.parametrize("addr,strides", [
    (0x7f0000000008, None),                    # base off 16 bytes
    (0x7f0000000000, (65536, 64, 2052, 1)),    # row stride not 8 elements
    (0x7f0000000000, (65540, 64, 2048, 1)),    # batch stride
])
def test_alignment_refuses_what_cp_async_cannot_copy(addr, strides):
    shape, good = _model_layout_view(4, 1024, 32, 64)
    with pytest.raises(ValueError, match="not aligned"):
        tfa.check_aligned("q", shape, strides or good, addr)


def test_alignment_ignores_strides_of_size_one_axes():
    tfa.check_aligned("q", (1, 1, 16, 64), (3, 5, 64, 1), 0x1000)


def _qkv_model_layout(B, S, H, K, D, dtype, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype).requires_grad_()
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]


@pytest.mark.parametrize("mode", [None, "torch"])
def test_bf16_cpu_call_reaches_the_plain_versions(monkeypatch, mode):
    """A bf16 CPU call takes the plain forward and backward whatever its
    route would be on the card, and counts no launch of any route."""
    calls = []
    for name in ("flash_attention_torch", "flash_attention_bwd_torch"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    for name in ("flash_attention", "flash_attention_bwd"):
        monkeypatch.setattr(tfa, name, lambda *a, **kw: pytest.fail(
            "a CPU call reached a kernel"))
    tops.reset_launches()
    q, k, v = _qkv_model_layout(1, 32, 4, 2, 64, torch.bfloat16, seed=5)
    out = tops.flash_attention(q, k, v, causal=True, mode=mode)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16
    assert calls == ["flash_attention_torch", "flash_attention_bwd_torch"]
    assert tops.LAUNCHES == {n: 0 for n in tops.LAUNCHES}


@pytest.mark.parametrize("dtype,D,route", [(torch.bfloat16, 64, "mma"),
                                           (torch.bfloat16, 128, "mma"),
                                           (torch.float32, 64, "simt"),
                                           (torch.bfloat16, 256, "simt")])
def test_launches_are_counted_by_route(monkeypatch, dtype, D, route):
    """ops counts each forward and backward launch in its total and under
    its route (the kernels stood in for by their plain versions, as the
    card is absent)."""
    monkeypatch.setattr(tfa, "flash_attention", tfa.flash_attention_torch)
    monkeypatch.setattr(tfa, "flash_attention_bwd",
                        tfa.flash_attention_bwd_torch)
    tops.reset_launches()
    q, k, v = _qkv_model_layout(1, 16, 4, 2, D, dtype, seed=6)
    tops.flash_attention(q, k, v, mode="cuda").float().sum().backward()
    with torch.no_grad():
        tops.flash_attention(q, k, v, mode="cuda")
    other = "simt" if route == "mma" else "mma"
    want = {n: 0 for n in tops.LAUNCHES}
    want.update({"flash_attention": 2, f"flash_attention_{route}": 2,
                 "flash_attention_bwd": 1, f"flash_attention_bwd_{route}": 1})
    assert tops.LAUNCHES == want
    assert tops.LAUNCHES[f"flash_attention_{other}"] == 0


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """Editing a csrc/*.cuh header changes every source's library name, so
    no stale build is loaded; editing another source's file does not."""
    for name in ("flash_attention.cu", "masked_update.cu", "mma_sm90.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n).name
              for n in ("flash_attention", "masked_update")}
    (tmp_path / "mma_sm90.cuh").write_text(
        (tmp_path / "mma_sm90.cuh").read_text() + "\n// edited\n")
    after = {n: _build.library_path(n).name
             for n in ("flash_attention", "masked_update")}
    assert all(before[n] != after[n] for n in before)
    (tmp_path / "masked_update.cu").write_text("// edited\n")
    assert _build.library_path("flash_attention").name == \
        after["flash_attention"]
    assert _build.library_path("masked_update").name.startswith(
        "libmasked_update-")
