"""The port's SimpleDenseNet (`tunevlseg_torch/models/simple_dense_net.py`)
and MNIST trainer (`scripts/torch_train_mnist.py`) against the JAX package's
(`tunevlseg_tpu/models/simple_dense_net.py`, `scripts/train_mnist.py`), on
the CPU, the same seeded numpy weights, statistics and inputs in both.

Tolerances: forwards, the new batch statistics and the weights after three
Adam steps 1e-5 absolute (f32, the same formulas, sums in another order;
flax's variance is E[x^2] - E[x]^2, the port's the mean squared deviation).
The data helpers are equal exactly."""
import functools
import gzip
import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_torch.convert.from_jax import simple_dense_net_state_dict  # noqa: E402
from tunevlseg_torch.models.simple_dense_net import SimpleDenseNet  # noqa: E402
from tunevlseg_tpu.models.simple_dense_net import \
    SimpleDenseNet as JaxSimpleDenseNet  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SIZES = dict(lin1_size=16, lin2_size=12, lin3_size=8)
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name[:-3], REPO / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def nets():
    """(JAX net, its variables, port net loaded with them): weights at
    1/sqrt(fan_in), BatchNorm scales near 1 and running statistics away from
    their initial 0 / 1, all from one numpy generator."""
    rng = np.random.default_rng(0)
    jnet = JaxSimpleDenseNet(**SIZES)
    widths = (784, SIZES["lin1_size"], SIZES["lin2_size"], SIZES["lin3_size"])
    params, stats = {}, {}
    for i in range(1, 4):
        fan_in, width = widths[i - 1], widths[i]
        params[f"lin{i}"] = {"kernel": rng.normal(size=(fan_in, width)) / np.sqrt(fan_in),
                             "bias": 0.1 * rng.normal(size=width)}
        params[f"bn{i}"] = {"scale": 1 + 0.1 * rng.normal(size=width),
                            "bias": 0.1 * rng.normal(size=width)}
        stats[f"bn{i}"] = {"mean": 0.2 * rng.normal(size=width),
                           "var": rng.uniform(0.5, 1.5, width)}
    params["head"] = {"kernel": rng.normal(size=(widths[3], 10)) / np.sqrt(widths[3]),
                      "bias": 0.1 * rng.normal(size=10)}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       {"params": params, "batch_stats": stats})
    shapes = jax.eval_shape(functools.partial(jnet.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 28, 28)))
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(variables)
    tnet = SimpleDenseNet(**SIZES)
    tnet.load_state_dict(simple_dense_net_state_dict(variables, tnet))
    return jnet, variables, tnet


def _inputs(seed=1, n=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _port_stats(net) -> dict:
    return {f"bn{i}": {"mean": getattr(net, f"bn{i}").running_mean.clone(),
                       "var": getattr(net, f"bn{i}").running_var.clone()}
            for i in range(1, 4)}


def test_eval_forward_matches_jax(nets):
    jnet, variables, tnet = nets
    x, _ = _inputs()
    want = jnet.apply(variables, jnp.asarray(x), train=False)
    tnet.eval()
    with torch.no_grad():
        _close(tnet(torch.from_numpy(x)), want)


def test_train_forward_and_batch_stats_match_jax(nets):
    """Train mode: the logits with the batch's statistics, and the running
    statistics after the call, as flax moves them (momentum 0.9 towards the
    batch mean and the BIASED batch variance). torch's BatchNorm1d would
    move the variance towards the unbiased one, which this batch tells
    apart by far more than the tolerance."""
    jnet, variables, tnet = nets
    x, _ = _inputs(2, n=8)
    want, upd = jnet.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    port = SimpleDenseNet(**SIZES)
    port.load_state_dict(tnet.state_dict())
    port.train()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want)
    got = _port_stats(port)
    for i in range(1, 4):
        for k in ("mean", "var"):
            _close(got[f"bn{i}"][k], upd["batch_stats"][f"bn{i}"][k])
    # the layer-1 pre-activations of the batch: torch's unbiased update
    h = x.reshape(8, -1) @ np.asarray(variables["params"]["lin1"]["kernel"]) + \
        np.asarray(variables["params"]["lin1"]["bias"])
    old = np.asarray(variables["batch_stats"]["bn1"]["var"])
    unbiased = 0.9 * old + 0.1 * h.var(0, ddof=1)
    assert np.abs(unbiased - np.asarray(upd["batch_stats"]["bn1"]["var"])).max() > 100 * TOL


def test_three_adam_steps_with_scaled_gradients_match_jax(nets):
    """The MNIST script's step (cross-entropy, BatchNorm statistics, the
    plateau's scale on the gradients, Adam) three times, against the JAX
    script's step written out with optax: the loss of each step, every
    weight and the running variances at 1e-5.

    The bias of each Linear feeds a train-mode BatchNorm, which subtracts
    it again: the loss does not depend on it, its gradient is rounding noise
    (held under 1e-6 in both packages at the first step, where every other
    gradient is far above), and Adam turns that noise into steps of up to
    lr each way. Those three biases, and the running means that average
    them in, are held to what Adam allows: |update| <= 3.17 lr a step
    (lr (1 - b1) / sqrt(1 - b2), Kingma & Ba section 2.1), so two packages
    at most 2 x 3 x 3.17 lr apart after three steps, the running means 0.1
    of that. The logits after the steps, in train mode, do not see them and
    are held at 1e-5."""
    jnet, variables, tnet = nets
    mnist = _script("torch_train_mnist.py")
    lr, scales = 1e-3, (1.0, 0.1, 0.1)
    tx = optax.adam(lr)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    def loss_fn(p, stats, xb, yb):
        logits, upd = jnet.apply({"params": p, "batch_stats": stats}, xb,
                                 train=True, mutable=["batch_stats"])
        return (optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean(), upd["batch_stats"])

    @jax.jit
    def jstep(params, stats, opt_state, scale, xb, yb):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, xb, yb)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(lambda g: g * scale, grads), opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    port = SimpleDenseNet(**SIZES)
    port.load_state_dict(tnet.state_dict())
    opt = torch.optim.Adam(port.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for step, scale in enumerate(scales):
        x, y = _inputs(10 + step)
        if step == 0:
            jgrads = jax.grad(lambda p: loss_fn(p, stats, jnp.asarray(x),
                                                jnp.asarray(y))[0])(params)
        params, stats, opt_state, jloss = jstep(params, stats, opt_state, scale,
                                                jnp.asarray(x), jnp.asarray(y))
        loss = mnist.train_step(port, opt, scale, torch.from_numpy(x),
                                torch.from_numpy(y))
        _close(loss, jloss)
        if step == 0:
            for i in range(1, 4):
                for g in (getattr(port, f"lin{i}").bias.grad,
                          jgrads[f"lin{i}"]["bias"]):
                    assert float(np.abs(np.asarray(g)).max()) < 1e-6
                for g in (getattr(port, f"lin{i}").weight.grad,
                          getattr(port, f"bn{i}").weight.grad):
                    assert float(g.abs().max()) > 1e-3
    want = simple_dense_net_state_dict({"params": params, "batch_stats": stats}, port)
    got = port.state_dict()
    assert set(got) == set(want)
    adam_bound = 2 * len(scales) * lr * 0.1 / np.sqrt(1e-3)
    for name, value in want.items():
        if name.endswith(("1.bias", "2.bias", "3.bias")) and name.startswith("lin"):
            _close(got[name], value, adam_bound)
        elif name.endswith("running_mean"):
            _close(got[name], value, 0.1 * adam_bound)
        else:
            _close(got[name], value)
    moved = simple_dense_net_state_dict(variables, port)
    assert all(not torch.equal(got[n], moved[n]) for n in got), "every tensor moves"
    x, _ = _inputs(20)
    jlogits, _ = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jlogits)


def _write_idx(path: Path, arr: np.ndarray, code: int) -> None:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as fp:
        fp.write(struct.pack(">HBB", 0, code, arr.ndim))
        fp.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        fp.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())


def test_read_idx_and_load_mnist_match_jax(tmp_path):
    """`read_idx` round-trips uint8 / int32 / float32 IDX files (plain and
    .gz), and `load_mnist` and `synthetic_mnist` give the JAX script's
    arrays exactly."""
    port, ref = _script("torch_train_mnist.py"), _script("train_mnist.py")
    rng = np.random.default_rng(0)
    for arr, code, name in (
            (np.arange(24, dtype=np.uint8).reshape(2, 3, 4), 0x08, "probe-idx3-ubyte"),
            (rng.integers(-9, 9, (5, 2)).astype(np.int32), 0x0C, "probe-i32.gz"),
            (rng.normal(size=(3, 2)).astype(np.float32), 0x0D, "probe-f32")):
        _write_idx(tmp_path / name, arr, code)
        np.testing.assert_array_equal(port.read_idx(tmp_path / name), arr)
    data = tmp_path / "mnist"
    data.mkdir()
    for split, n in (("train", 12), ("t10k", 6)):
        _write_idx(data / f"{split}-images-idx3-ubyte.gz",
                   rng.integers(0, 256, (n, 28, 28)).astype(np.uint8), 0x08)
        _write_idx(data / f"{split}-labels-idx1-ubyte",
                   rng.integers(0, 10, n).astype(np.uint8), 0x08)
    for got, want in zip(port.load_mnist(data), ref.load_mnist(data)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for g, w in zip(port.synthetic_mnist(64, seed=3), ref.synthetic_mnist(64, seed=3)):
        np.testing.assert_array_equal(g, w)


def test_train_mnist_cli_on_the_cpu():
    """`torch_train_mnist --synthetic --epochs 3 --device cpu`, as the JAX
    script's smoke test runs it: it learns the synthetic digits."""
    result = _script("torch_train_mnist.py").main(
        ["--synthetic", "--epochs", "3", "--device", "cpu"])
    assert result["val_acc"] > 0.9
    assert np.isfinite(result["test_loss"]) and result["test_acc"] > 0.9
    assert len(result["epoch_seconds"]) == 3
