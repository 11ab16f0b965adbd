"""tpu3d_torch's RMSprop on the CPU: the optimizer's step is the plain
three-line update (kernels/rmsprop.py::rmsprop_update_plain) bit for bit and
launches nothing, the wrapper's checks, and a module that imports and runs
without nvcc or a card. The kernel itself is held to the plain version on
the card (tests/test_torch_gpu.py)."""
import importlib

import pytest
import torch

from tpu3d_torch.dense.train import RMSprop
from tpu3d_torch.kernels import LAUNCHES, _build
from tpu3d_torch.kernels import rmsprop as rk


def _formula(p, g, nu, lr, d, eps):
    """The optimizer's update as it was written before the kernel, copied
    literally."""
    nu.mul_(d).add_((1 - d) * (g * g))
    p.addcmul_(torch.add(nu, eps).rsqrt_().mul_(lr), g, value=-1.0)


@pytest.mark.parametrize("shape, lr_kind", [((8, 16, 16, 28), "tensor"),
                                            ((1_000_003,), "float"), ((5, 7), "tensor"),
                                            ((3, 4, 28), "float")],
                         ids=["grid-tensor_lr", "ragged-float_lr", "small-tensor_lr",
                              "small-float_lr"])
def test_rmsprop_step_on_the_cpu_is_the_formula(shape, lr_kind):
    """Three steps of RMSprop.step, the lr changed between them and a
    gradient that is zero on a slab in the second, against the literal
    formula on copies: p and nu bit for bit. A second parameter without a
    gradient stays as it was; no kernel launch is counted."""
    gen = torch.Generator().manual_seed(3)
    p0 = torch.randn(shape, generator=gen)
    grads = [torch.randn(shape, generator=gen) * 0.05 for _ in range(3)]
    grads[1][:1] = 0.0
    lr0 = 0.01
    p = torch.nn.Parameter(p0.clone())
    q = torch.nn.Parameter(torch.ones(4))
    opt = RMSprop([p, q], lr=torch.tensor(lr0) if lr_kind == "tensor" else lr0)
    ref_p, ref_nu = p0.clone(), torch.zeros(shape)
    before = LAUNCHES["rmsprop_kernel"]
    for k, g in enumerate(grads):
        lr = lr0 * 0.5 ** k
        for group in opt.param_groups:
            if lr_kind == "tensor":
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr
        p.grad = g.clone()
        opt.step()
        _formula(ref_p, g, ref_nu, torch.tensor(lr) if lr_kind == "tensor" else lr, 0.95, 1e-8)
        assert torch.equal(p.detach(), ref_p), k
        assert torch.equal(opt.state[p]["nu"], ref_nu), k
    assert torch.equal(q.detach(), torch.ones(4))
    assert torch.equal(opt.state[q]["nu"], torch.zeros(4))
    assert LAUNCHES["rmsprop_kernel"] == before == 0


@pytest.mark.parametrize("bad", ["g_shape", "nu_shape", "g_dtype", "nu_dtype", "g_device",
                                 "device"])
def test_rmsprop_update_rejects_what_it_does_not_take(bad):
    """Mismatched shapes, dtypes or devices, and a device that is neither
    the CPU nor a card, raise before anything is updated."""
    p, g, nu = torch.ones(6, 4), torch.ones(6, 4), torch.zeros(6, 4)
    if bad == "g_shape":
        g = torch.ones(4, 6)
    elif bad == "nu_shape":
        nu = torch.zeros(24)
    elif bad == "g_dtype":
        g = g.double()
    elif bad == "nu_dtype":
        nu = nu.half()
    elif bad == "g_device":
        g = torch.ones(6, 4, device="meta")
    else:
        p, g, nu = (t.to("meta") for t in (p, g, nu))
    with pytest.raises(ValueError, match="rmsprop_update"):
        rk.rmsprop_update(p, g, nu, 0.01, 0.95, 1e-8)
    if bad != "device":
        assert torch.equal(p, torch.ones(6, 4))
        assert not nu.is_meta and not nu.any()


def test_rmsprop_module_imports_and_runs_without_nvcc(monkeypatch):
    """The module imports without building anything, and a CPU tensor's
    update never reaches the kernel library: with the build and the
    library's loader made to fail, a reload and an update still work."""
    def no_library(*args, **kwargs):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "build", no_library)
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(_build, "_functions", {})
    module = importlib.reload(rk)
    p, g, nu = torch.ones(5), torch.full((5,), 0.5), torch.zeros(5)
    module.rmsprop_update(p, g, nu, torch.tensor(0.1), 0.95, 1e-8)
    ref_p, ref_nu = torch.ones(5), torch.zeros(5)
    _formula(ref_p, g, ref_nu, torch.tensor(0.1), 0.95, 1e-8)
    assert torch.equal(p, ref_p) and torch.equal(nu, ref_nu)
