"""What the port's kernel wrappers share (``adascale_torch.kernels._nvcc``):
the build key, and the rule that a wrapper runs its plain version only for a
CPU tensor and raises, not falls back, on any other device."""
import pytest
import torch

from adascale_torch.kernels import _nvcc, convnext_block, fpn_heads, fpn_neck, precise_heads


def test_build_key_covers_source_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    source = tmp_path / "kernel.cu"
    source.write_text("a")
    keys = [_nvcc._digest(source)]
    for text in ("x", "y"):
        (tmp_path / "shared.cuh").write_text(text)
        keys.append(_nvcc._digest(source))
    source.write_text("b")
    keys.append(_nvcc._digest(source))
    monkeypatch.setattr(_nvcc, "NVCC_FLAGS", _nvcc.NVCC_FLAGS + ["-lineinfo"])
    keys.append(_nvcc._digest(source))
    assert len(set(keys)) == len(keys)


@pytest.mark.parametrize(
    "call",
    [
        lambda x: convnext_block.convnext_block(x, {}),
        lambda x: fpn_neck.fused_neck_l0(x, x, {}),
        lambda x: fpn_heads.fused_rough_heads(x, {}, {}),
        lambda x: precise_heads.fused_precise_heads(x, [{}] * 4),
    ],
    ids=["convnext_block", "fpn_neck", "fpn_heads", "precise_heads"],
)
def test_wrappers_raise_on_a_device_without_their_kernel(call):
    x = torch.empty(1, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="device|CUDA"):
        call(x)



@pytest.mark.parametrize("wrapper", ["fused_neck_l0", "fused_rough_heads", "fused_precise_heads"])
def test_refuse_grad_raises_only_where_a_gradient_is_wanted(wrapper):
    """The fused neck and heads kernels have no backward: on the card their
    wrappers call ``_nvcc.refuse_grad`` before the launch, which raises
    where grad is enabled and the input or a parameter requires grad, and
    lets serving (inference mode, no_grad, frozen tensors) through."""
    x = torch.zeros(1, 2, 2, 4)
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{wrapper}: .*no backward.*module neck and heads"):
        _nvcc.refuse_grad(wrapper, x, w)
    with pytest.raises(RuntimeError, match=wrapper):
        _nvcc.refuse_grad(wrapper, x.clone().requires_grad_(), torch.zeros(3))
    _nvcc.refuse_grad(wrapper, x, w.detach())
    with torch.no_grad():
        _nvcc.refuse_grad(wrapper, x, w)
    with torch.inference_mode():
        _nvcc.refuse_grad(wrapper, x, w)


@pytest.mark.cuda
def test_bf16_shapes_the_kernels_cannot_take_raise_on_the_card():
    """On the card a bf16 call the kernels cannot take raises and launches
    nothing: bf16 needs C % 8 == 0 (16-byte copies of 8 channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from adascale_torch.models.fpn import FpnHead

    x = torch.zeros(1, 4, 4, 12, dtype=torch.bfloat16, device="cuda")
    heads = [fpn_heads.head_params(FpnHead(12, m).cuda()) for m in (1, 2, 4, 4)]
    before = (fpn_heads.LAUNCHES_BF16, precise_heads.LAUNCHES_BF16)
    with pytest.raises(ValueError, match="C % 8"):
        fpn_heads.fused_rough_heads(x, heads[0], heads[1])
    with pytest.raises(ValueError, match="C % 8"):
        precise_heads.fused_precise_heads(x, heads)
    assert (fpn_heads.LAUNCHES_BF16, precise_heads.LAUNCHES_BF16) == before
