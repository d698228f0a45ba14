"""Run directories shared by the JAX package and the port, on the CPU.

* the optax globals the port writes are those a real optax state pickles
  under (the installed optax), and its reader maps them back;
* each package loads the other's run directory (params, optimizer state,
  BatchNorm statistics, stamp) and continues it for one epoch; each
  continuation is allclose (atol 1e-5) to the other package's own
  continuation of its own directory, for a GNGF per-row run with
  BatchNorm and a vanilla run;
* the port reads JAX's ``whole_opt.pkl`` in a process that never imports
  jax or optax, and its reader refuses any other global;
* ``-hwp``: the loaded HPD stays bitwise unchanged over 2 epochs, in the
  port and in JAX alike; ``-ewp``: the loaded tables start the run;
* the config stamp: equal configs pass both ways, a drifted field raises
  ``CheckpointMismatchError`` both ways;
* a 1-epoch warm start from a 3-epoch fit's best checkpoint (its last
  epoch) gives a 4-epoch fit's parameters bitwise, on three routes.
"""

import dataclasses
import os
import pickle
import pickletools
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train.optimizer import make_optimizer as jax_optimizer
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu.utils import checkpoint as jckpt
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.train import optimizer as topt
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "gngf_bn": dict(batchnorm_input=True),
    "vanilla": dict(use_hash_function=True),
}


def _globals(blob: bytes) -> set:
    """(module, name) of every STACK_GLOBAL in a protocol-4 pickle."""
    strings, memo, out = [], {}, set()
    for op, arg, _ in pickletools.genops(blob):
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE"):
            strings.append(arg)
        elif op.name == "MEMOIZE":
            memo[len(memo)] = strings[-1] if strings else None
        elif op.name in ("BINGET", "LONG_BINGET", "GET"):
            strings.append(memo.get(arg))
        elif op.name == "STACK_GLOBAL":
            out.add((strings[-2], strings[-1]))
    return out


def _jax_state(kw, freeze_hpd=False):
    m = jcfg.ModelConfig(**kw)
    params = jgngf.init_params(jax.random.PRNGKey(0), m)
    tx = jax_optimizer(jcfg.OptimizerConfig(), params, freeze_hpd=freeze_hpd)
    return params, jax.tree_util.tree_map(np.asarray, tx.init(params))


@pytest.mark.parametrize("kw", [dict(batchnorm_input=True), dict(use_hash_function=True)])
def test_optax_globals_pinned(kw):
    """A real optax state pickles under exactly the globals the port writes
    (OPTAX_GLOBALS and numpy's array reconstructors), and the port's
    pickle of its own state of the same run names the same ones."""
    jparams, state = _jax_state(kw)
    real = _globals(pickle.dumps(state))
    assert {g for g in real if g[0].startswith("optax")} == set(ckpt.OPTAX_GLOBALS.values())
    tp = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    opt = topt.make_optimizer(tcfg.OptimizerConfig(), tp)
    import io

    buf = io.BytesIO()
    ckpt._Pickler(buf, protocol=4).dump(ckpt._to_host(topt.to_optax_state(opt, tp)))
    assert _globals(buf.getvalue()) == real


def _leaves_equal(a, b, path="state"):
    """Structure (optax class names vs stand-ins) and leaves bitwise."""
    if hasattr(a, "_fields") or hasattr(b, "_fields"):
        assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
        assert a._fields == b._fields, path
        for f in a._fields:
            _leaves_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _leaves_equal(x, y, f"{path}[{i}]")
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _image():
    return np.random.default_rng(65535).integers(0, 256, size=(23, 20, 3)).astype(np.uint8)


def _exps(kw, ckpt_dir, save=True):
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**kw))
    texp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**kw))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(
        jexp.train, save_params=save, checkpoint_dir=str(ckpt_dir), checkpoint_min_interval_s=0.0))
    texp = dataclasses.replace(texp, train=dataclasses.replace(
        texp.train, save_params=save, checkpoint_dir=str(ckpt_dir), checkpoint_min_interval_s=0.0))
    return jexp, texp


def _data(kw):
    data = image_dataset(_image(), "synthetic", normalize=not kw.get("batchnorm_input", False))
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    return data, jdata


@pytest.fixture(scope="module", params=sorted(RUNS))
def shared(request, tmp_path_factory):
    """Both packages fit 3 epochs from one start and write their run
    directories; each then continues both directories for 1 epoch."""
    kw = RUNS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    jexp, texp = _exps(kw, root)
    data, jdata = _data(kw)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jres = jax_fit(jexp, jdata, epochs=3, verbose=False, run_name="jax")
    tres = fit(texp, data, epochs=3, device="cpu", params=start, verbose=False, run_name="port")
    assert jres.run_dir != tres.run_dir
    jexp1, texp1 = _exps(kw, root, save=False)
    cont = {}
    for who, d in (("jax", jres.run_dir), ("port", tres.run_dir)):
        j = jax_fit(jexp1, jdata, epochs=1, verbose=False, warm_start_dir=d)
        cont[("jax", who)] = jax.tree_util.tree_map(np.asarray, (j.state.params, j.state.bn_state))
        t = fit(texp1, data, epochs=1, device="cpu", verbose=False, warm_start_dir=d)
        cont[("port", who)] = (gngf.params_to_numpy(t.params), gngf.bn_state_to_numpy(t.params))
    return request.param, texp, jres, tres, cont


def test_run_directories_hold_the_same_artifacts(shared):
    name, texp, jres, tres, _ = shared
    files = sorted(os.listdir(jres.run_dir))
    assert sorted(os.listdir(tres.run_dir)) == files
    want = {"whole_model.pkl", "whole_opt.pkl", "encoding_model.pkl", "MLP_model.pkl",
            "checkpoint_meta.json"}
    want |= {"HPD_model.pkl"} if name != "vanilla" else set()
    want |= {"bn_state.pkl"} if texp.model.batchnorm_input else set()
    assert set(files) == want


def test_each_package_reads_the_others_directory(shared):
    """Params, BatchNorm statistics (atol 1e-5: two trainings) and the
    optimizer state's structure, count and moments (atol 1e-5) agree; the
    port's reader maps optax's classes to its stand-ins and back."""
    _, texp, jres, tres, _ = shared
    jp, jopt, jbn = jckpt.load_run_checkpoint(tres.run_dir, model_cfg=jres_model(texp))
    tp, topt_state, tbn = ckpt.load_run_checkpoint(jres.run_dir, model_cfg=texp.model)
    jp_own, jopt_own, jbn_own = jckpt.load_run_checkpoint(jres.run_dir)
    close = dict(rtol=0, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, **close)
    if tbn is not None:
        for k in ("mean", "var"):
            np.testing.assert_allclose(tbn[k], np.asarray(jbn[k]), **close)
    # the JAX-read port state has optax's structure; counts equal, moments close
    jopt_np = jax.tree_util.tree_map(np.asarray, jopt)
    own_np = jax.tree_util.tree_map(np.asarray, jopt_own)
    assert jax.tree_util.tree_structure(jopt_np) == jax.tree_util.tree_structure(own_np)
    for a, b in zip(jax.tree_util.tree_leaves(jopt_np), jax.tree_util.tree_leaves(own_np)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **close)
    # the port's reading of JAX's file, written back, is JAX's file
    params = gngf.params_from_jax(tp, bn_state=tbn)
    opt = topt.make_optimizer(tcfg.OptimizerConfig(), params)
    topt.load_optax_state(opt, params, topt_state)
    _leaves_equal(topt.to_optax_state(opt, params), topt_state)
    assert type(topt_state) is ckpt.PartitionState


def jres_model(texp):
    """The JAX package's ModelConfig of the port's (same fields, same values)."""
    fields = {f.name: getattr(texp.model, f.name) for f in dataclasses.fields(texp.model)}
    for name, enum_type in (("hidden_activation", jcfg.HiddenActivation),
                            ("topk_blend", jcfg.TopkBlendMode),
                            ("topk_scatter", jcfg.TopkScatterMode)):
        fields[name] = enum_type(fields[name].value)
    return jcfg.ModelConfig(**fields)


def test_continuations_match_across_packages(shared):
    """Each package's 1-epoch continuation of the other's directory is
    allclose (atol 1e-5) to the other package's continuation of its own."""
    *_, cont = shared
    for reader, writer in (("jax", "port"), ("port", "jax")):
        a_params, a_bn = cont[(reader, writer)]
        b_params, b_bn = cont[(writer, writer)]
        a_leaves = jax.tree_util.tree_leaves(a_params)
        b_leaves = jax.tree_util.tree_leaves(b_params)
        assert len(a_leaves) == len(b_leaves)
        for a, b in zip(a_leaves, b_leaves):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f"{reader} reads {writer}")
        if b_bn is not None:
            for k in ("mean", "var"):
                np.testing.assert_allclose(a_bn[k], b_bn[k], rtol=0, atol=1e-5)


def test_port_reads_jax_opt_state_without_jax(tmp_path):
    """A subprocess loads JAX's whole_opt.pkl through the port's reader and
    neither jax nor optax is imported."""
    _, state = _jax_state(dict(batchnorm_input=True), freeze_hpd=True)
    path = tmp_path / "whole_opt.pkl"
    with open(path, "wb") as f:
        pickle.dump(state, f)
    code = (
        "import sys; from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as c; "
        f"s = c.load_pytree({str(path)!r}); "
        "assert type(s).__name__ == 'PartitionState' and sorted(s.inner_states) == "
        "['encoding', 'frozen', 'hpd', 'mlp']; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax') "
        "or m.startswith('collision_handling_in_instantngp_tpu.')]; "
        "assert not bad, bad; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_reader_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"f": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        ckpt.load_pytree(str(path))


def test_hpd_weights_frozen_and_encoding_weights(tmp_path):
    """-hwp: the HPD of a JAX HPD_model.pkl loads and stays bitwise
    unchanged over 2 epochs, in the port and in JAX, and the two fits agree
    (atol 1e-5); -ewp: a JAX encoding_model.pkl's tables start the run."""
    kw = dict(batchnorm_input=True)
    jexp, texp = _exps(kw, tmp_path, save=False)
    data, jdata = _data(kw)
    other = jgngf.init_params(jax.random.PRNGKey(7), jexp.model)
    hpd_path, enc_path = str(tmp_path / "HPD_model.pkl"), str(tmp_path / "encoding_model.pkl")
    jckpt.save_pytree(other["hpd"], hpd_path)
    jckpt.save_pytree(other["tables"], enc_path)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jres = jax_fit(jexp, jdata, epochs=2, verbose=False, hpd_weights_path=hpd_path)
    tres = fit(texp, data, epochs=2, device="cpu", params=start, verbose=False,
               hpd_weights_path=hpd_path)
    want = jax.tree_util.tree_map(np.asarray, other["hpd"])
    for got in (gngf.params_to_numpy(tres.params)["hpd"],
                jax.tree_util.tree_map(np.asarray, jres.state.params["hpd"])):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    tp = gngf.params_to_numpy(tres.params)
    np.testing.assert_allclose(tp["tables"], np.asarray(jres.state.params["tables"]), atol=1e-5)

    t0 = fit(texp, data, epochs=0, device="cpu", params=start, verbose=False,
             encoding_weights_path=enc_path)
    np.testing.assert_array_equal(t0.params.tables.detach().numpy(), np.asarray(other["tables"]))
    jres = jax_fit(jexp, jdata, epochs=1, verbose=False, encoding_weights_path=enc_path)
    tres = fit(texp, data, epochs=1, device="cpu", params=start, verbose=False,
               encoding_weights_path=enc_path)
    np.testing.assert_allclose(tres.params.tables.detach().numpy(),
                               np.asarray(jres.state.params["tables"]), atol=1e-5)


def test_stamp_checked_both_ways(tmp_path):
    """The defaults stamp to the same strings; each package accepts the
    other's stamp of an equal config and raises CheckpointMismatchError on
    a drifted field."""
    jm, tm = jcfg.ModelConfig(), tcfg.ModelConfig()
    js = {k: str(v) for k, v in jckpt._config_stamp(jm).items()}
    ts = {k: str(v) for k, v in ckpt._config_stamp(tm).items()}
    assert set(js) == set(ts)
    assert js == ts
    tree = {"tables": np.zeros((1, 2, 1), np.float32), "mlp": []}
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_run_checkpoint(jdir, tree, {}, model_cfg=jm)
    ckpt.save_run_checkpoint(tdir, tree, {}, model_cfg=tm)
    jckpt.validate_run_checkpoint(tdir, jm)
    ckpt.validate_run_checkpoint(jdir, tm)
    with pytest.raises(jckpt.CheckpointMismatchError, match="hash_table_size"):
        jckpt.validate_run_checkpoint(tdir, dataclasses.replace(jm, hash_table_size=512))
    with pytest.raises(ckpt.CheckpointMismatchError, match="topk_k"):
        ckpt.validate_run_checkpoint(jdir, dataclasses.replace(tm, topk_k=20))
    with pytest.raises(ckpt.CheckpointMismatchError, match="hidden_activation"):
        ckpt.validate_run_checkpoint(jdir, dataclasses.replace(
            tm, hidden_activation=tcfg.HiddenActivation.LEAKY_RELU))


WARM = {
    "vanilla": dict(use_hash_function=True),
    "dedup": dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48,
                  hpd_backend="unique_stream", mlp_hidden=(16,)),
    "per_row_bn": dict(batchnorm_input=True),
}


@pytest.mark.parametrize("name", sorted(WARM))
def test_warm_start_equals_continuing(name, tmp_path):
    """A 3-epoch fit whose best epoch is its last, warm-started for 1 epoch,
    gives the parameters (and BatchNorm statistics) of a 4-epoch fit bit for
    bit: the pixels are never re-shuffled, the table gradients sum in a
    fixed order, and the collision-loss term, reset at the warm start,
    carries no gradient."""
    kw = WARM[name]
    _, texp = _exps(kw, tmp_path)
    data, _ = _data(kw)
    three = fit(texp, data, epochs=3, device="cpu", verbose=False, run_name="three")
    psnrs = [row["train_psnr"] for row in three.history]
    assert psnrs[-1] == max(psnrs), psnrs
    _, texp1 = _exps(kw, tmp_path, save=False)
    warm = fit(texp1, data, epochs=1, device="cpu", verbose=False, warm_start_dir=three.run_dir)
    four = fit(texp1, data, epochs=4, device="cpu", verbose=False)
    sa, sb = warm.params.state_dict(), four.params.state_dict()
    assert sorted(sa) == sorted(sb)
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert not differ, differ
