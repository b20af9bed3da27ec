"""The bfloat16 weight copies a bf16 model holds across calls
(``models/tracknet.weight_as``), on the CPU at small sizes: Se3TrackNet at a
48^2 ROI, the refiner at base width 8.

With autograd off a bf16 forward casts each float32 weight once for each
version of the parameter and then reads the held copy, bit for bit the
per-call cast; ``load_state_dict``, an in-place ``copy_``, an optimizer step
and ``.to()`` each make the next forward cast again and give a freshly built
model's outputs. A forward with autograd on casts on every call and gives
the gradients of a model that never held a copy; ``parallel/spmd``'s stacked
``functional_call``/``vmap`` path, inference tensors and a float32 model
hold nothing; ``copy.deepcopy``, ``as_float64`` and ``state_dict`` carry no
copy. The counters ``weights.bf16_casts`` and ``weights.bf16_held`` count
the casts and the held copies used."""
import copy

import pytest
import torch
from torch.func import functional_call

from iros20_6d_pose_tracking_tpu_torch.models import refinenet, tracknet
from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)
BF16 = torch.bfloat16
KINDS = ["se3tracknet", "refiner"]
# weight and bias casts of one forward: 17 convolutions and 2 Linear; 20
# convolutions, 2 x 2 Linear and 2 x (in-projection + out-projection + 2
# feed-forward) in the refiner's heads
CASTS = {"se3tracknet": 38, "refiner": 50}


def _build(kind, dtype=BF16, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if kind == "se3tracknet":
            net = tracknet.init_params(tracknet.Se3TrackNet(48, dtype),
                                       torch.Generator().manual_seed(seed))
        else:
            net = refinenet.RefineNet(dtype, base=8)
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith("bias"):
                    p.add_(torch.rand(p.shape, generator=g) * 0.2 - 0.1)
    return net.eval()


def _inputs(kind, batch=2):
    g = torch.Generator().manual_seed(5)
    ch = 4 if kind == "se3tracknet" else 6
    return (torch.rand(batch, 48, 48, ch, generator=g),
            torch.rand(batch, 48, 48, ch, generator=g))


def _fresh(net, kind):
    """A model built anew with ``net``'s state: it has held nothing."""
    other = _build(kind, net.dtype, seed=99)
    other.load_state_dict(net.state_dict())
    return other


def _counts():
    c = profiling.counters()
    return c["weights.bf16_casts"], c["weights.bf16_held"]


def _forward(net, A, B, grad=False):
    """The outputs, and the (casts, held) counted over the forward."""
    before = _counts()
    with torch.set_grad_enabled(grad):
        out = net(A, B)
    after = _counts()
    return out, (after[0] - before[0], after[1] - before[1])


def _equal(a, b):
    for k in ("trans", "rot"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", KINDS)
def test_no_grad_forward_equals_per_call_cast(kind):
    """The first no-grad forward casts every weight, the next reads the held
    copies; both equal a forward with autograd on, which casts on every
    call. The state_dict gains nothing."""
    net = _build(kind)
    keys = list(net.state_dict())
    A, B = _inputs(kind)
    per_call, counts = _forward(net, A, B, grad=True)
    assert counts == (CASTS[kind], 0)
    assert tracknet.held_weights(net) == []
    first, counts = _forward(net, A, B)
    assert counts == (CASTS[kind], 0)
    second, counts = _forward(net, A, B)
    assert counts == (0, CASTS[kind])
    _equal(first, per_call)
    _equal(second, per_call)
    held = tracknet.held_weights(net)
    assert len(held) == CASTS[kind]
    assert all(c.dtype == BF16 for _, c in held)
    assert list(net.state_dict()) == keys


def _load_state_dict(net, kind):
    other = _build(kind, seed=3)
    net.load_state_dict(other.state_dict())
    return CASTS[kind]


def _copy_(net, kind):
    w = dict(net.named_parameters())[
        "rot_out.0.weight" if kind == "se3tracknet" else "rot_head.1.weight"]
    with torch.no_grad():
        w.copy_(w * 1.5)
    return 1


def _optimizer_step(net, kind):
    opt = torch.optim.SGD(net.parameters(), lr=0.05)
    out = net(*_inputs(kind))
    (out["trans"].square().sum() + out["rot"].square().sum()).backward()
    opt.step()
    return CASTS[kind]


def _to(net, kind):
    net.to(torch.float64)
    with torch.no_grad():
        next(net.parameters()).mul_(1.5)
    net.to(torch.float32)
    return CASTS[kind]


@pytest.mark.parametrize("change", [_load_state_dict, _copy_,
                                    _optimizer_step, _to],
                         ids=["load_state_dict", "copy_", "optimizer_step",
                              "to"])
@pytest.mark.parametrize("kind", KINDS)
def test_changed_weights_are_cast_again(kind, change):
    """After each way of changing the weights, the next no-grad forward
    casts the changed ones again and gives a freshly built model's
    outputs, bit for bit; the one after reads held copies only."""
    net = _build(kind)
    A, B = _inputs(kind)
    before, _ = _forward(net, A, B)
    _forward(net, A, B)
    cast = change(net, kind)
    got, counts = _forward(net, A, B)
    assert counts == (cast, CASTS[kind] - cast)
    want, _ = _forward(_fresh(net, kind), A, B)
    _equal(got, want)
    assert not torch.equal(got["rot"], before["rot"])
    again, counts = _forward(net, A, B)
    assert counts == (0, CASTS[kind])
    _equal(again, want)


@pytest.mark.parametrize("kind", KINDS)
def test_grad_forward_casts_per_call(kind):
    """A forward and backward with autograd on, after no-grad forwards that
    hold copies, casts every weight and gives the gradients on the float32
    parameters of a model that never held one."""
    net, ref = _build(kind), _build(kind)
    A, B = _inputs(kind)
    _forward(net, A, B)
    _forward(net, A, B)
    held = len(_held_of(net))
    grads = []
    for m in (net, ref):
        out, counts = _forward(m, A, B, grad=True)
        assert counts == (CASTS[kind], 0)
        (out["trans"].square().sum() + out["rot"].square().sum()).backward()
        grads.append([p.grad for p in m.parameters()])
    assert tracknet.held_weights(ref) == []
    assert len(_held_of(net)) == held
    for g, r in zip(*grads):
        assert g.dtype == torch.float32
        assert torch.equal(g, r)


def _held_of(net):
    return [p for p in net.parameters() if p in tracknet._held]


def test_stacked_ensemble_holds_nothing():
    """``spmd``'s stacked networks run through ``vmap`` of
    ``functional_call`` (in float32) and hold nothing; a bf16 model run by
    ``functional_call`` on tensors swapped in for its parameters, the
    stacked path's mechanism, casts them on every call, holds no copy and
    gives the model's own outputs."""
    nets = [_build("se3tracknet", torch.float32, seed=s) for s in (0, 1)]
    state = spmd.stack_states(nets)
    A, B = _inputs("se3tracknet")
    before = _counts()
    with torch.no_grad():
        trans, rot = spmd.ensemble_forward(state)(A, B)
    assert _counts() == before
    assert trans.shape == rot.shape == (2, 3)
    assert not any(t in tracknet._held for t in state.params.values())

    net = _build("se3tracknet")
    swapped = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for _ in range(2):
        before = _counts()
        with torch.no_grad():
            got = functional_call(net, swapped, (A, B))
        after = _counts()
        assert (after[0] - before[0], after[1] - before[1]) == (
            CASTS["se3tracknet"], 0)
    assert _held_of(net) == [] and tracknet.held_weights(net) == []
    want, _ = _forward(net, A, B)
    _equal(got, want)


def test_float32_model_holds_nothing():
    """A float32 model's weights are used as they are: no cast, no copy,
    neither counter moves, with autograd off or on."""
    net = _build("se3tracknet", torch.float32)
    A, B = _inputs("se3tracknet")
    for grad in (False, True, False):
        _, counts = _forward(net, A, B, grad=grad)
        assert counts == (0, 0)
    assert _held_of(net) == []


def test_inference_tensors_are_cast_per_call():
    """Parameters made under ``torch.inference_mode`` have no readable
    version: they are cast on every call, and nothing is held."""
    with torch.inference_mode():
        net = _build("se3tracknet")
        A, B = _inputs("se3tracknet")
        first, counts = _forward(net, A, B)
        assert counts == (CASTS["se3tracknet"], 0)
        second, counts = _forward(net, A, B)
        assert counts == (CASTS["se3tracknet"], 0)
    assert next(net.parameters()).is_inference()
    _equal(first, second)
    assert _held_of(net) == []


@pytest.mark.parametrize("how", ["deepcopy", "as_float64"])
def test_copies_do_not_travel(how):
    """A deep copy of a model that holds copies holds none: changed in place,
    it casts again and gives a fresh model's outputs, while the original
    still reads its own. ``as_float64`` of a model that ran in bfloat16
    (``Tracker.from_parts`` sets ``dtype``) runs in float64 and casts
    nothing."""
    net = _build("se3tracknet")
    A, B = _inputs("se3tracknet")
    mine, _ = _forward(net, A, B)
    if how == "deepcopy":
        other = copy.deepcopy(net)
        assert _held_of(other) == []
        _copy_(other, "se3tracknet")
        got, counts = _forward(other, A, B)
        assert counts == (CASTS["se3tracknet"], 0)
        want, _ = _forward(_fresh(other, "se3tracknet"), A, B)
        _equal(got, want)
        again, counts = _forward(net, A, B)
        assert counts == (0, CASTS["se3tracknet"])
        _equal(again, mine)
    else:
        net.dtype = torch.float32
        wide = tracknet.as_float64(net)
        assert _held_of(wide) == []
        out, counts = _forward(wide, A.double(), B.double())
        assert counts == (0, 0)
        assert out["trans"].dtype == torch.float64
