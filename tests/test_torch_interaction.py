"""The dot interaction's plain version, wrapper checks and gradient, on the CPU.

`kernels/interaction` has a CUDA kernel (checked on the card by
chip_smoke.py's `interaction` phase) and a plain version, which the
dispatch takes for CPU tensors. Here the plain version is held to the code
`DLRM._interact` ran before the kernel (a cat, the Gram `bmm`, the pair
gather, a cat: the same operations, so bit for bit), the wrapper to the
inputs it refuses, and the plain backward of the CUDA route to autograd
through that code in float64. The JAX package's order of pairs is held by
tests/test_torch_dlrm.py.
"""
import pytest
import torch

from repro_torch.kernels.interaction import kernel as interaction


def _former_interact(bottom_out, pooled):
    """`DLRM._interact`'s dot branch as it was, with its pair buffer."""
    feats = torch.cat([bottom_out[:, None, :], pooled], dim=1)
    t = feats.shape[1]
    iu, ju = torch.triu_indices(t, t, offset=1)
    gram = torch.bmm(feats, feats.transpose(1, 2))
    return torch.cat([bottom_out, gram[:, iu, ju]], dim=1)


def _inputs(batch, features, dim, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bottom = torch.randn(batch, dim, generator=gen, dtype=torch.float64)
    pooled = torch.randn(batch, features - 1, dim, generator=gen,
                         dtype=torch.float64)
    return bottom.to(dtype), pooled.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [16, 128])
@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("features", [3, 9, 27])
def test_ref_equals_former_interact(features, batch, dim, dtype):
    bottom, pooled = _inputs(batch, features, dim, dtype)
    got = interaction.dot_interaction_ref(bottom, pooled)
    assert got.shape == (batch, dim + features * (features - 1) // 2)
    assert got.dtype == dtype
    assert torch.equal(got, _former_interact(bottom, pooled))
    assert torch.equal(interaction.dot_interaction(bottom, pooled), got)


def test_pairs_are_row_major_dot_products():
    """Column D + i(2F - i - 1)/2 + (j - i - 1) holds <x_i, x_j>, i < j:
    the columns the kernel writes."""
    bottom, pooled = _inputs(2, 6, 4, torch.float64)
    z = interaction.dot_interaction_ref(bottom, pooled)
    x = torch.cat([bottom[:, None], pooled], 1)
    f, d = 6, 4
    torch.testing.assert_close(z[:, :d], bottom, rtol=0, atol=0)
    for i in range(f):
        for j in range(i + 1, f):
            col = d + i * (2 * f - i - 1) // 2 + (j - i - 1)
            torch.testing.assert_close(z[:, col], (x[:, i] * x[:, j]).sum(1))


def _bad_inputs(case):
    bottom, pooled = _inputs(4, 5, 8)
    if case == "float64":
        return bottom.double(), pooled.double()
    if case == "int32":
        return bottom.int(), pooled.int()
    if case == "mixed_dtypes":
        return bottom, pooled.to(torch.bfloat16)
    if case == "bottom_not_contiguous":
        return torch.randn(8, 4).t(), pooled
    if case == "pooled_not_contiguous":
        return bottom, torch.randn(4, 8, 4).transpose(1, 2)
    if case == "mismatched_dim":
        return bottom[:, :7].contiguous(), pooled
    if case == "mismatched_batch":
        return bottom[:3].contiguous(), pooled
    if case == "bottom_not_2d":
        return bottom[:, None], pooled
    if case == "too_many_features":
        return bottom, torch.zeros(4, interaction.MAX_FEATURES, 8)
    assert case == "cpu_tensors"
    return bottom, pooled


@pytest.mark.parametrize("case,match", [
    ("float64", "float32 or bfloat16"), ("int32", "float32 or bfloat16"),
    ("mixed_dtypes", "float32 or bfloat16"),
    ("bottom_not_contiguous", "contiguous"),
    ("pooled_not_contiguous", "contiguous"),
    ("mismatched_dim", r"\[B, D\]"), ("mismatched_batch", r"\[B, D\]"),
    ("bottom_not_2d", r"\[B, D\]"), ("too_many_features", "at most"),
    ("cpu_tensors", "CUDA")])
def test_wrapper_refuses(case, match):
    """The wrapper checks before anything is built or launched."""
    before = interaction.LAUNCHES
    with pytest.raises(ValueError, match=match):
        interaction.dot_interaction_cuda(*_bad_inputs(case))
    assert interaction.LAUNCHES == before == 0


def test_cuda_request_without_card_raises():
    """Asking for the CUDA route where there is no card raises (a CPU-only
    torch raises an AssertionError, a CUDA torch without a card a
    RuntimeError); nothing falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises((RuntimeError, AssertionError), match="cuda|CUDA"):
        interaction.dot_interaction(torch.zeros(2, 8, device="cuda"),
                                    torch.zeros(2, 3, 8, device="cuda"))


def test_cpu_path_does_not_launch():
    from repro_torch.core.embedding import EmbeddingStageConfig
    from repro_torch.models import DLRM, DLRMConfig

    bottom, pooled = _inputs(3, 5, 8)
    interaction.dot_interaction(bottom, pooled)
    cfg = DLRMConfig(dense_features=4, bottom_mlp=(16, 8), top_mlp=(8, 1),
                     embedding=EmbeddingStageConfig(num_tables=4, rows=50,
                                                    dim=8, pooling=3))
    model = DLRM(cfg, device="cpu")
    idx = torch.randint(0, 50, (3, 4, 3), dtype=torch.int32)
    with torch.inference_mode():
        model(torch.randn(3, 4), idx)
    assert interaction.LAUNCHES == 0


def _autograd_grads(bottom, pooled, grad):
    b = bottom.clone().requires_grad_()
    p = pooled.clone().requires_grad_()
    return torch.autograd.grad(_former_interact(b, p), (b, p), grad)


@pytest.mark.parametrize("batch,features,dim", [
    (1, 2, 3), (4, 3, 16), (5, 9, 64), (3, 27, 16), (2, 40, 33)])
def test_backward_matches_autograd(batch, features, dim):
    """The CUDA route's plain backward against autograd through the former
    code, in float64."""
    bottom, pooled = _inputs(batch, features, dim, torch.float64, seed=1)
    grad = torch.randn(batch, dim + features * (features - 1) // 2,
                       dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2))
    got = interaction.dot_interaction_backward(bottom, pooled, grad)
    want = _autograd_grads(bottom, pooled, grad)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_autograd_function_wires_the_backward(monkeypatch):
    """`DotInteraction` saves its inputs and returns both gradients in
    order; its forward (the kernel) is replaced by the plain version so
    that it runs on the CPU."""
    monkeypatch.setattr(interaction, "dot_interaction_cuda",
                        interaction.dot_interaction_ref)
    bottom, pooled = _inputs(3, 7, 5, torch.float64, seed=3)
    b = bottom.clone().requires_grad_()
    p = pooled.clone().requires_grad_()
    z = interaction.DotInteraction.apply(b, p)
    grad = torch.randn_like(z)
    got = torch.autograd.grad(z, (b, p), grad)
    want = _autograd_grads(bottom, pooled, grad)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(interaction.DotInteraction.apply,
                                    (b, p))
