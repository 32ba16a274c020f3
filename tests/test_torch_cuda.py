"""PyTorch port on a CUDA card: the fused RHS kernel and the main path through it.

Every test needs a card and skips where there is none.  The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)  The
reference is the plain PyTorch version of the same function, on the same
card, at the 2e-5 float32 bound of ``tests/test_ops_misc.py``.
"""
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
from universal_differential_equations_torch.models import fisher_kpp as tfk
from universal_differential_equations_torch.ops import stencil

pytestmark = pytest.mark.cuda

PAPER = (1, 10, 20, 10, 1)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(seed, n, device, sizes=PAPER, rows=None):
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if rows is None else (rows, n)
    u = torch.rand(shape, generator=g).to(device)
    taps = torch.tensor([6.25, -12.5, 6.25], device=device)
    d0 = torch.tensor(0.7, device=device)
    mlp = [(w, 0.1 * torch.randn(b.shape, generator=g).to(device))
           for w, b in stencil.make_pointwise_mlp_params(g, sizes, device=device)]
    return u, taps, d0, mlp


def _flat(mlp):
    return [x for wb in mlp for x in wb]


@pytest.mark.parametrize("sizes", [PAPER, (1, 3, 1)])
@pytest.mark.parametrize("n", [26, 1024, 131072])
def test_kernel_matches_plain(cuda_device, sizes, n):
    args = _inputs(0, n, cuda_device, sizes)
    before = stencil.launches
    out = stencil.fused_updet_rhs(*args)
    torch.cuda.synchronize()
    assert stencil.launches == before + 1
    torch.testing.assert_close(out, stencil.updet_rhs_torch(*args), **TOL)


def test_kernel_rows(cuda_device):
    args = _inputs(1, 1024, cuda_device, rows=8)
    torch.testing.assert_close(stencil.fused_updet_rhs(*args),
                               stencil.updet_rhs_torch(*args), **TOL)


@pytest.mark.parametrize("n", [26, 300])
@pytest.mark.parametrize("pick", ["left", "right"])
def test_kernel_periodic_wrap(cuda_device, n, pick):
    u = torch.zeros(n, device=cuda_device)
    u[0], u[-1] = 1.0, 2.0
    taps = torch.tensor([1.0, 0.0, 0.0] if pick == "left" else [0.0, 0.0, 1.0],
                        device=cuda_device)
    mlp = [(torch.zeros(1, 1, device=cuda_device), torch.zeros(1, device=cuda_device))]
    out = stencil.fused_updet_rhs(u, taps, torch.tensor(1.0, device=cuda_device), mlp)
    assert torch.equal(out, torch.roll(u, 1 if pick == "left" else -1))


def test_autograd_function_jvp_and_grad_match_plain(cuda_device):
    u, taps, d0, mlp = _inputs(2, 1024, cuda_device)
    primals = (u, taps, d0, *_flat(mlp))
    g = torch.Generator().manual_seed(20)
    tangents = tuple(torch.randn(p.shape, generator=g).to(cuda_device) for p in primals)

    def plain(u_, t_, d_, *f):
        return stencil.updet_rhs_torch(u_, t_, d_, stencil._pairs(f))

    _, jvp_k = torch.func.jvp(stencil.FusedUpdetRHS.apply, primals, tangents)
    _, jvp_p = torch.func.jvp(plain, primals, tangents)
    torch.testing.assert_close(jvp_k, jvp_p, rtol=1e-4, atol=1e-4)
    leaves = [p.clone().requires_grad_(True) for p in primals]
    grads_k = torch.autograd.grad((stencil.FusedUpdetRHS.apply(*leaves) ** 2).sum(), leaves)
    grads_p = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


def test_vmap_rule_sends_states_as_rows(cuda_device):
    u, taps, d0, mlp = _inputs(3, 512, cuda_device, rows=4)
    before = stencil.launches
    out = torch.func.vmap(lambda uu: stencil.FusedUpdetRHS.apply(uu, taps, d0, *_flat(mlp)))(u)
    assert stencil.launches == before + 1
    torch.testing.assert_close(out, stencil.updet_rhs_torch(u, taps, d0, mlp), **TOL)


def test_kernel_raises_instead_of_falling_back(cuda_device):
    u, taps, d0, mlp = _inputs(4, 64, cuda_device, sizes=(1, 3, 1))
    with pytest.raises(TypeError):
        stencil.fused_updet_rhs(u.double(), taps.double(), d0.double(),
                                [(w.double(), b.double()) for w, b in mlp])
    strided = torch.stack([u, u], dim=1)[:, 0]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        stencil.fused_updet_rhs(strided, taps, d0, mlp)
    wide = [(torch.zeros(1, 65, device=cuda_device), torch.zeros(65, device=cuda_device)),
            (torch.zeros(65, 1, device=cuda_device), torch.zeros(1, device=cuda_device))]
    with pytest.raises(ValueError):
        stencil.fused_updet_rhs(u, taps, d0, wide)


def test_model_rhs_goes_through_the_kernel(cuda_device):
    rhs, params = tfk.make_model(torch.Generator().manual_seed(0), "mlp", device=cuda_device)
    rhs_cpu, params_cpu = tfk.make_model(torch.Generator().manual_seed(0), "mlp")
    u = torch.rand(tfk.NX, generator=torch.Generator().manual_seed(1))
    assert tfk._use_fused(u.to(cuda_device)) and not tfk._use_fused(u)
    before = stencil.launches
    out = rhs(0.0, u.to(cuda_device), params)
    torch.cuda.synchronize()
    assert stencil.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), rhs_cpu(0.0, u, params_cpu).numpy(), **TOL)


def test_lm_main_path_goes_through_the_kernel(cuda_device):
    ts, ys = tfk.generate_data(device=cuda_device)
    rhs, params0 = tfk.make_model(torch.Generator().manual_seed(0), "mlp", device=cuda_device)

    def residuals(p):
        sol = tude.solve(tude.ODEProblem(rhs, ys[0], (0.0, tfk.T_END), p), tude.Tsit5(),
                         saveat=ts, rtol=1e-4, atol=1e-6,
                         adjoint=tude.ForwardSensitivity(), max_steps=192)
        pen = torch.sqrt(tfk.zero_sum_penalty(p) + 1e-30)
        r = torch.cat([(sol.ys - ys).reshape(-1), pen[None]])
        return torch.where(sol.success, r, torch.inf)

    loss0 = float(torch.sum(residuals(params0) ** 2))
    before = stencil.launches
    res = tude.levenberg_marquardt(residuals, params0, maxiters=2)
    assert stencil.launches > before
    assert np.isfinite(float(res.loss)) and float(res.loss) <= loss0
