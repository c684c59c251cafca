"""The port's supervised joint and separated paths against the JAX package's.

The JAX models run on their composed path (``set_pallas_enabled(False)``,
restored after this module). Both sides start from the port's seeded
initial variables: ``bridge.to_flax_numpy`` names them as flax does
(``params`` and the BatchNormEps ``batch_stats``), and their tree must equal
the JAX model's own, by ``jax.eval_shape`` of its ``init``. Batches of 8
seeded CIRs, errors, labels and a padding weight with a zero in it. Dropout
masks are drawn by flax from the step's key and injected into the port
(threefry and Philox give different streams): in the same jitted call as the
JAX step, an interceptor records each Dropout's output on a forward with the
step's key and variables, and keep = output != 0.

Checked: the Conv heads alone in train and eval mode and their running
stats after 2 steps; the joint step of EMNet and EMNetLoop (Linear and Conv
heads): loss parts, metric sums, every gradient by flax name, the parameters
and ``batch_stats`` after 1 and 3 Adam steps, the eval step after 1; sep-E,
sep-M and ``sep_em_marginalized_inference``; one semi step of IInsVAE with
Conv1d heads; the bridge's round trip of every new tree; the 2-class
classifier's route to K4's small-head path.

Tolerances (fp32): outputs, losses, metric sums, running stats and the
gradients of the first step rtol 5e-4 / atol 5e-5. Parameters in units of
lr, as tests/test_torch_training.py gives them: Adam's first update is
lr * g / (|g| + 1e-8), so a gradient entry that is rounding noise moves its
parameter by a share of lr that the rounding decides. After one step,
entries whose JAX gradient is >= 1e-6 agree within 0.01 lr, and every entry
within 2 lr, the most two first updates can differ by: the Conv heads' biases
before LeakyReLU and BatchNormEps have exactly zero gradient in every
channel whose inputs are all positive, so each side moves them by up to lr
in a direction its rounding picks (the restorer's Conv1d_1 bias: 1.13 lr).
After three steps, every entry within 3 lr and the mean within 0.05 lr.
Those differences feed the later steps' forward: their metrics and running
stats are held within rtol 5e-3 / atol 5e-4 (EMNet at the seed below reads
a loss 1.3e-3 apart at the third step, where the residual blocks' taps
differ by 1.9 lr after the second: a second gradient that nearly cancels the
first gives Adam's update the sign the rounding decides), the eval step
after the first step rtol 1e-3 / atol 1e-4.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.models import EMNet as JaxEMNet
from iinsvae_tpu.models import EMNetLoop as JaxEMNetLoop
from iinsvae_tpu.models import IdentifierSep as JaxIdentifierSep
from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.models import RegressorSep as JaxRegressorSep
from iinsvae_tpu.models import heads as jheads
from iinsvae_tpu.ops.pallas import fused as pallas_fused
from iinsvae_tpu.training import losses as jlosses
from iinsvae_tpu.training import optim as joptim
from iinsvae_tpu.training import state as jstate
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.models import heads
from iinsvae_torch.models.emnet import EMNet, EMNetLoop, IdentifierSep, RegressorSep
from iinsvae_torch.models.layers import dropout_source
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops.kernels import fused
from iinsvae_torch.training import steps
from iinsvae_torch.training.state import create_train_state

RTOL, ATOL = 5e-4, 5e-5
# the metrics of a step after the first read parameters that differ by up to
# 3 lr (the first step's within RTOL / ATOL)
LATER = {False: (RTOL, ATOL), True: (5e-3, 5e-4)}
LR = 1e-3
B = 8


@pytest.fixture(scope="module", autouse=True)
def composed():
    """The JAX models on their composed path (pallas off) for this module;
    the module-global switch is restored afterwards."""
    was = pallas_fused.pallas_enabled()
    pallas_fused.set_pallas_enabled(False)
    try:
        yield
    finally:
        pallas_fused.set_pallas_enabled(was)


def _batch(num_classes: int, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    weight = np.ones(B, np.float32)
    weight[5] = 0.0  # a padded row
    return {"cir": rng.normal(size=(B, 157)).astype(np.float32),
            "err": np.abs(0.3 * rng.normal(size=(B, 1))).astype(np.float32),
            "label": rng.integers(0, num_classes, size=(B, 1)).astype(np.float32),
            "weight": weight}


def _flat(variables) -> dict[str, np.ndarray]:
    return {f"{col}/{k}": np.asarray(v) for col, tree in variables.items()
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _shapes(variables) -> dict[str, tuple]:
    return {f"{col}/{k}": tuple(v.shape) for col, tree in variables.items()
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_shapes(jax_model, *example) -> dict[str, tuple]:
    """The JAX model's variable shapes, from ``init`` traced, not run."""
    return _shapes(jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)}, *example))


def _jax_variables(port, jax_model, *example) -> dict:
    """The port's initial variables as a flax tree, which must have the JAX
    model's own structure and shapes."""
    flat = bridge.to_flax_numpy(port.state_dict())
    assert {k: v.shape for k, v in flat.items()} == _jax_shapes(jax_model, *example)
    tree = flax.traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                              for k, v in flat.items()})
    return {"batch_stats": {}, **tree}


def _compare(got: dict, want: dict, what: str, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want), f"{what}: {set(got) ^ set(want)}"
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _masks_of(forward) -> dict:
    """Run ``forward()`` (a flax apply in train mode) and return each
    Dropout's keep mask (output != 0) by module path, as traced values: call
    it inside the jitted function that runs the step."""
    masks = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            masks[".".join(context.module.path)] = out != 0
        return out

    with fnn.intercept_methods(record):
        forward()
    return masks


def _torch_masks(masks: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in masks.items()}


def _tensors(batch: dict) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(v) for k, v in batch.items()}


def _params_in_lr(model, jstate_) -> dict[str, np.ndarray]:
    got = bridge.to_flax_numpy(dict(model.named_parameters()))
    return {k: np.abs(got[k] - v) / LR for k, v in _flat({"params": jstate_.params}).items()}


def _check_params(diff: dict, first_grads: dict, i: int) -> None:
    if i == 0:
        for k, d in diff.items():
            big = np.abs(first_grads[k]) >= 1e-6
            assert d[big].max(initial=0.0) <= 0.01 and d.max() <= 2.0, k
    if i == 2:
        everything = np.concatenate([d.ravel() for d in diff.values()])
        assert everything.max() <= 3.0 and everything.mean() <= 0.05


def _check_stats(model, jstate_, i: int) -> None:
    got = {k: v for k, v in bridge.to_flax_numpy(model.state_dict()).items()
           if k.startswith("batch_stats/")}
    _compare(got, _flat({"batch_stats": jstate_.batch_stats}), f"step {i} running stats",
             *LATER[bool(i)])


def _grads(model) -> dict[str, np.ndarray]:
    return bridge.to_flax_numpy({n: p.grad for n, p in model.named_parameters()})


def _state(model, n_epochs: int = 3):
    """Adam at LR, halved at the third step (the LambdaLR decay active), on both sides."""
    tx = joptim.make_optimizer(LR, 0.5, 0.999, n_epochs=n_epochs, decay_start_epoch=1,
                               steps_per_epoch=1)
    port = create_train_state(model, LR, 0.5, 0.999, n_epochs=n_epochs, decay_start_epoch=1,
                              steps_per_epoch=1)
    return tx, port


# ---------------------------------------------------------------- the Conv heads alone


HEADS = {
    "RestorerConv1d": (lambda: jheads.RestorerConv1d(),
                       lambda g: heads.RestorerConv1d((8, 2), generator=g), (B, 8, 2)),
    "RestorerConv1d_2d_code": (lambda: jheads.RestorerConv1d(conv_type=2, expand=True),
                               lambda g: heads.RestorerConv1d((8, 8, 2), generator=g),
                               (B, 8, 8, 2)),
    "RestorerConv2d": (lambda: jheads.RestorerConv2d(),
                       lambda g: heads.RestorerConv2d((8, 2), generator=g), (B, 8, 2)),
    "RestorerConv2d_2d_code": (lambda: jheads.RestorerConv2d(conv_type=2, expand=True),
                               lambda g: heads.RestorerConv2d((8, 8, 2), generator=g),
                               (B, 8, 8, 2)),
    "ClassifierConv1d": (lambda: jheads.ClassifierConv1d(2),
                         lambda g: heads.ClassifierConv1d(16, 2, generator=g), (B, 16)),
    "ClassifierConv2d": (lambda: jheads.ClassifierConv2d(5),
                         lambda g: heads.ClassifierConv2d(16, 5, generator=g), (B, 16)),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_conv_head_matches_jax_in_train_and_eval_mode(name):
    """Two train-mode forwards (dropout injected, batch statistics, the
    running stats moved twice), then one in eval mode (the running stats)."""
    make_jax, make_port, shape = HEADS[name]
    jm = make_jax()
    rng = np.random.default_rng(3)
    xs = [jnp.asarray(rng.normal(size=shape).astype(np.float32)) for _ in range(3)]
    port = make_port(torch.Generator().manual_seed(0))
    variables = {"params": {}, "batch_stats": {}}
    for k, v in port.state_dict().items():
        mod, leaf = k.split(".")
        col = "batch_stats" if leaf in ("mean", "var") else "params"
        variables[col].setdefault(mod, {})[leaf] = jnp.asarray(v.numpy())
    assert _shapes(variables) == _jax_shapes(jm, xs[0])

    @jax.jit
    def train(variables, x, key):
        def forward():
            return jm.apply(variables, x, train=True, mutable=["batch_stats"],
                            rngs={"dropout": key})
        masks = _masks_of(forward)
        out, mut = forward()
        return out, mut["batch_stats"], masks

    for i, x in enumerate(xs[:2]):
        want, stats, masks = train(variables, x, jax.random.PRNGKey(10 + i))
        variables = {**variables, "batch_stats": stats}
        port.train()
        with dropout_source(port, masks=_torch_masks(masks)):
            got = port(torch.from_numpy(np.array(x)))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        assert sorted(masks) == ["Dropout_0", "Dropout_1"]
        assert 0 < sum(int((~np.asarray(m)).sum()) for m in masks.values())  # some dropped
    got = {k: v.numpy() for k, v in port.state_dict().items() if k.endswith(("mean", "var"))}
    _compare(got, {k.replace("batch_stats/", "").replace("/", "."): v
                   for k, v in _flat({"batch_stats": variables["batch_stats"]}).items()},
             "running stats")
    port.eval()
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, xs[2])
    np.testing.assert_allclose(port(torch.from_numpy(np.array(xs[2]))).detach().numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_dropout_needs_a_source_in_train_mode_and_checks_mask_names():
    head = heads.ClassifierConv1d(16, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 16)
    with pytest.raises(RuntimeError, match="generator or an injected mask"):
        head(x)
    with pytest.raises(KeyError, match="no Dropout named"):
        with dropout_source(head, masks={"Dropout_7": torch.ones(4, 1, 16, dtype=torch.bool)}):
            pass
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    with dropout_source(head, g1):
        a = head(x)
    with dropout_source(head, g2):
        b = head(x)
    assert torch.equal(a, b)  # one seed, one draw
    head.eval()
    assert torch.equal(head(x), head(x))  # eval: no dropout, the running stats


# ---------------------------------------------------------------- the joint step


JOINT = [("loop", "Linear", "Linear", 2), ("loops", "Conv1d", "Conv2d", 5)]
METRICS = ("loss", "loss_idy", "loss_reg", "se", "ae", "correct", "count")


@pytest.mark.parametrize("ablation,enet,mnet,num_classes", JOINT)
def test_joint_step_matches_jax(ablation, enet, mnet, num_classes):
    jcls, tcls = {"loop": (JaxEMNet, EMNet), "loops": (JaxEMNetLoop, EMNetLoop)}[ablation]
    jm = jcls(num_classes=num_classes, enet_type=enet, mnet_type=mnet)
    port = tcls(num_classes=num_classes, enet_type=enet, mnet_type=mnet,
                generator=torch.Generator().manual_seed(2))
    variables = _jax_variables(port, jm, jnp.ones((2, 157)))
    tx, state = _state(port)
    jstate_ = jstate.create_train_state(jm, variables, tx)
    jgrads = jsteps.make_joint_grads_fn(jm)
    jeval = jsteps.make_joint_eval_step(jm)

    @jax.jit
    def jax_step(jstate_, batch, key):
        masks = _masks_of(lambda: jstate_.apply_fn(
            {"params": jstate_.params, "batch_stats": jstate_.batch_stats}, batch["cir"],
            train=True, mutable=["batch_stats"], rngs={"dropout": key}))
        grads, metrics, mut = jgrads(jstate_, batch, key)
        new = jstate_.apply_gradients(grads).replace(
            batch_stats=mut.get("batch_stats", jstate_.batch_stats))
        return grads, metrics, masks, new, jeval(new, batch)

    grads_fn = steps.make_joint_grads_fn()
    batch = _batch(num_classes)
    jbatch, tbatch = {k: jnp.asarray(v) for k, v in batch.items()}, _tensors(batch)
    for i in range(3):
        grads, jm_, masks, jstate_, evaluated = jax_step(jstate_, jbatch,
                                                         jax.random.PRNGKey(30 + i))
        assert len(masks) == (enet != "Linear") * 2 + (mnet != "Linear") * 2
        tm = grads_fn(port, tbatch, dropout_masks=_torch_masks(masks))
        _compare({k: tm[k].item() for k in METRICS}, {k: float(jm_[k]) for k in METRICS},
                 f"step {i} metric", *LATER[bool(i)])
        if i == 0:
            first_grads = _flat({"params": grads})
            _compare(_grads(port), first_grads, "gradient")
        state.apply_gradients()
        _check_params(_params_in_lr(port, jstate_), first_grads, i)
        _check_stats(port, jstate_, i)
        if i == 0:  # the eval step in eval mode on the moved running stats, the mode restored
            want_m, (want_logits, want_latent, want_est) = evaluated
            got_m, got = steps.make_joint_eval_step()(port, tbatch)
            assert port.training
            _compare({k: v.item() for k, v in got_m.items()},
                     {k: float(v) for k, v in want_m.items()}, "eval metric", 1e-3, 1e-4)
            for k, w in zip(steps.JOINT_OUTPUTS, (want_est, want_logits, want_latent)):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-3, atol=1e-4,
                                           err_msg=k)


def test_joint_step_draws_its_dropout_from_the_generator():
    """Conv heads without injected masks draw from the step's generator: one
    seed, one step; another seed, another. Without either the step raises."""
    def run(seed):
        model = EMNetLoop(num_classes=2, enet_type="Conv1d", mnet_type="Conv1d",
                          generator=torch.Generator().manual_seed(1))
        m = steps.make_joint_grads_fn()(model, _tensors(_batch(2)),
                                        torch.Generator().manual_seed(seed))
        return m["loss"].item(), model.regressor.restorer.Conv1d_0.kernel.grad.clone()

    (l1, g1), (l2, g2), (l3, _) = run(4), run(4), run(5)
    assert l1 == l2 and torch.equal(g1, g2) and l3 != l1
    with pytest.raises(RuntimeError, match="generator or an injected mask"):
        steps.make_joint_grads_fn()(EMNet(num_classes=2, enet_type="Conv1d"),
                                    _tensors(_batch(2)))


# ---------------------------------------------------------------- the separated path


SEP = [("e", "Conv2d"), ("m", "Conv1d"), ("m", "Linear")]


@pytest.mark.parametrize("stage,head", SEP)
def test_sep_step_matches_jax(stage, head):
    """sep-E (IdentifierSep, CE) or sep-M (RegressorSep, L1 on the true
    labels): the metrics of 3 steps, the first step's gradients, the
    parameters and running stats after each."""
    batch = _batch(2, seed=12)
    jbatch, tbatch = {k: jnp.asarray(v) for k, v in batch.items()}, _tensors(batch)
    gen = torch.Generator().manual_seed(3)
    if stage == "e":
        jm, port = (JaxIdentifierSep(num_classes=2, enet_type=head),
                    IdentifierSep(num_classes=2, enet_type=head, generator=gen))
        variables = _jax_variables(port, jm, jnp.ones((2, 157)))
        jstep, step = jsteps.make_sep_e_train_step(jm), steps.make_sep_e_train_step()
        args = lambda b: (b["cir"],)
        loss = lambda out, b: jlosses.cross_entropy(out[0], b["label"], b["weight"])
    else:
        jm, port = (JaxRegressorSep(num_classes=2, mnet_type=head),
                    RegressorSep(num_classes=2, mnet_type=head, generator=gen))
        variables = _jax_variables(port, jm, jnp.ones((2, 157)), jnp.zeros((2, 1)))
        jstep, step = jsteps.make_sep_m_train_step(jm), steps.make_sep_m_train_step()
        args = lambda b: (b["cir"], b["label"])
        loss = lambda out, b: jlosses.l1(out, b["err"], b["weight"])
    tx, state = _state(port)
    jstate_ = jstate.create_train_state(jm, variables, tx)

    @jax.jit
    def jax_step(jstate_, batch, key):
        def forward(params):
            return jstate_.apply_fn({"params": params, "batch_stats": jstate_.batch_stats},
                                    *args(batch), train=True, mutable=["batch_stats"],
                                    rngs={"dropout": key})
        masks = _masks_of(lambda: forward(jstate_.params))
        grads = jax.grad(lambda p: loss(forward(p)[0], batch))(jstate_.params)
        new, metrics = jstep(jstate_, batch, key)
        return grads, metrics, masks, new

    for i in range(3):
        grads, jm_, masks, jstate_ = jax_step(jstate_, jbatch, jax.random.PRNGKey(20 + i))
        assert len(masks) == (head != "Linear") * 2
        tm = step(state, tbatch, dropout_masks=_torch_masks(masks))
        _compare({k: v.item() for k, v in tm.items()}, {k: float(v) for k, v in jm_.items()},
                 f"step {i} metric", *LATER[bool(i)])
        if i == 0:
            first_grads = _flat({"params": grads})
            _compare(_grads(port), first_grads, "gradient")
        _check_params(_params_in_lr(port, jstate_), first_grads, i)
        _check_stats(port, jstate_, i)


def test_sep_em_inference_matches_jax():
    """The soft marginalised inference with Conv heads at 5 classes, on
    running stats moved off their init, and the models left in their mode."""
    nc = 5
    gen = torch.Generator().manual_seed(4)
    enet = IdentifierSep(num_classes=nc, enet_type="Conv1d", generator=gen)
    mnet = RegressorSep(num_classes=nc, mnet_type="Conv2d", generator=gen)
    with torch.no_grad():
        for bn in (enet.identifier.classifier.BatchNormEps_0, mnet.regressor.restorer.BatchNormEps_0):
            bn.mean.normal_(generator=gen)
            bn.var.uniform_(0.5, 2.0, generator=gen)
    je, jr = JaxIdentifierSep(num_classes=nc, enet_type="Conv1d"), JaxRegressorSep(
        num_classes=nc, mnet_type="Conv2d")
    es = jstate.create_train_state(je, _jax_variables(enet, je, jnp.ones((2, 157))),
                                   joptim.make_optimizer(LR))
    ms = jstate.create_train_state(jr, _jax_variables(mnet, jr, jnp.ones((2, 157)),
                                                      jnp.zeros((2, 1))),
                                   joptim.make_optimizer(LR))
    cir = _batch(nc)["cir"]
    want = jax.jit(lambda es, ms, c: jsteps.sep_em_marginalized_inference(es, ms, c, nc))(
        es, ms, jnp.asarray(cir))
    got = steps.sep_em_marginalized_inference(enet, mnet, torch.from_numpy(cir), nc)
    for name, a, w in zip(("label_est", "env_latent", "err_est"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)
    assert enet.training and mnet.training


# ---------------------------------------------------------------- the semi step, Conv heads


def test_semi_step_with_conv_heads_matches_jax():
    """One semi step of IInsVAE with Conv1d heads, mask and dropout keys as
    steps.py:135-165 splits them: metrics, gradients, parameters and running
    stats."""
    jm = JaxIInsVAE(cir_len=157, num_classes=5, style_dim=16, restorer_type="Conv1d",
                    classifier_type="Conv1d")
    port = IInsVAE(cir_len=157, num_classes=5, style_dim=16, restorer_type="Conv1d",
                   classifier_type="Conv1d", generator=torch.Generator().manual_seed(5))
    variables = _jax_variables(port, jm, jnp.ones((2, 157)))
    tx, state = _state(port)
    jstate_ = jstate.create_train_state(jm, variables, tx)
    jgrads = jsteps.make_semi_grads_fn(jm, 0.5)

    @jax.jit
    def jax_step(jstate_, batch, key):
        k_mask, k_sample, k_drop = jax.random.split(key, 3)
        masks = _masks_of(lambda: jstate_.apply_fn(
            {"params": jstate_.params, "batch_stats": jstate_.batch_stats}, batch["cir"],
            sample_key=k_sample, train=True, mutable=["batch_stats"], rngs={"dropout": k_drop}))
        grads, metrics, mut = jgrads(jstate_, batch, key)
        sup = jax.random.bernoulli(k_mask, 0.5, (B,)).astype(jnp.float32)
        return grads, metrics, masks, sup, jstate_.apply_gradients(grads).replace(
            batch_stats=mut["batch_stats"])

    batch = _batch(5)
    grads, jm_, masks, sup, jstate_ = jax_step(jstate_, {k: jnp.asarray(v)
                                                         for k, v in batch.items()},
                                               jax.random.PRNGKey(9))
    assert sorted(masks) == [f"{h}.{h}.Dropout_{i}" for h in ("classifier", "restorer")
                             for i in (0, 1)]
    tm = steps.make_semi_train_step(0.5)(state, _tensors(batch),
                                         sup_mask=torch.from_numpy(np.array(sup)),
                                         dropout_masks=_torch_masks(masks))
    keys = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "se", "ae", "correct",
            "count", "sup_count")
    _compare({k: tm[k].item() for k in keys}, {k: float(jm_[k]) for k in keys}, "metric")
    first_grads = _flat({"params": grads})
    _compare(_grads(port), first_grads, "gradient")
    _check_params(_params_in_lr(port, jstate_), first_grads, 0)
    _check_stats(port, jstate_, 0)


# ---------------------------------------------------------------- the bridge, the routing


TREES = {
    "EMNet_conv": (lambda: JaxEMNet(num_classes=2, enet_type="Conv1d", mnet_type="Conv2d"),
                   lambda: EMNet(num_classes=2, enet_type="Conv1d", mnet_type="Conv2d"), 1),
    "EMNetLoop": (lambda: JaxEMNetLoop(num_classes=5),
                  lambda: EMNetLoop(num_classes=5), 1),
    "IdentifierSep_conv": (lambda: JaxIdentifierSep(num_classes=2, enet_type="Conv2d"),
                           lambda: IdentifierSep(num_classes=2, enet_type="Conv2d"), 1),
    "RegressorSep_conv": (lambda: JaxRegressorSep(num_classes=2, mnet_type="Conv1d"),
                          lambda: RegressorSep(num_classes=2, mnet_type="Conv1d"), 2),
    "IInsVAE_conv": (lambda: JaxIInsVAE(cir_len=157, num_classes=5, style_dim=16,
                                        restorer_type="Conv2d", classifier_type="Conv1d"),
                     lambda: IInsVAE(cir_len=157, num_classes=5, style_dim=16,
                                     restorer_type="Conv2d", classifier_type="Conv1d"), 1),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_bridge_round_trips_every_new_tree(name):
    """The port's state named as flax names it has the JAX model's tree
    (parameters and running stats, shapes included); from_flax_numpy takes it
    back bit for bit and refuses a name of no model."""
    make_jax, make_port, n_args = TREES[name]
    port = make_port()
    flat = bridge.to_flax_numpy(port.state_dict())
    _jax_variables(port, make_jax(), *(jnp.ones((2, 157)), jnp.zeros((2, 1)))[:n_args])
    assert any(k.startswith("batch_stats/") for k in flat) == ("conv" in name)
    back = bridge.from_flax_numpy(flat)
    assert set(back) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
    if name == "IInsVAE_conv":
        geo = bridge.model_geometry(back)
        assert (geo["restorer_type"], geo["classifier_type"], geo["num_classes"]) == (
            "Conv2d", "Conv1d", 5)
        IInsVAE(cir_len=157, **geo).load_state_dict(back)
    with pytest.raises(KeyError):
        bridge.from_flax_numpy({**flat, "params/regressor/restorer/Dense_1/kernel": np.ones(1)})


def test_the_two_class_classifier_takes_k4s_small_head_path():
    """EMNet at nlos (2 classes): the classifier's widths 16 -> 16 -> 32 -> 16
    -> 2 route to K4's head kernel (its <Any> instance), the restorer's to the
    cluster kernel; a Conv head launches no K4 at all."""
    model = EMNet(num_classes=2)
    chain = model.identifier.classifier
    dims = [chain.w0.shape[0]] + [getattr(chain, f"w{j}").shape[1] for j in range(4)]
    assert dims == [16, 16, 32, 16, 2]
    assert fused.takes_mlp_head(dims) and not fused.takes_mlp_cluster(dims)
    r = model.regressor.restorer
    assert fused.takes_mlp_cluster([r.w0.shape[0]] + [getattr(r, f"w{j}").shape[1]
                                                      for j in range(4)])
    conv = EMNet(num_classes=2, enet_type="Conv1d", mnet_type="Conv2d")
    assert not any(isinstance(m, heads._MLPChain) for m in conv.modules())
