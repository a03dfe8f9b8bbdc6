"""The port's transformer LM (`llm/`, the LayerNorm, Embedding and
slice_axis ops, gluon `LayerNorm`) against the JAX package's on the CPU.

Both packages take the same numpy parameters and inputs.  Networks are
composed in a fresh thread in each package, so the per-thread name
counters start at 0 in both.  Tolerances: elementwise ops and gathers
are exact; a LayerNorm is held to rtol 1e-5 + 1e-6 * max|ref| (float32
sums in another order); an LM forward through 2 blocks, the decode
plane's logits and caches to rtol 1e-5 + 1e-5 * max|ref|.
"""
import json
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import llm as jllm

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import llm as tllm
from incubator_mxnet_tpu_torch.compat.weights import lm_params_from_numpy

OP_TOL = (1e-5, 1e-6)
LM_TOL = (1e-5, 1e-5)
CPU = tmx.cpu()


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fresh(fn):
    """fn() in a new thread (fresh name counters); returns its result."""
    out = {}

    def run():
        out["v"] = fn()

    t = threading.Thread(target=run)
    t.start()
    t.join(120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _cfg(pkg_llm=tllm, **kw):
    base = dict(vocab_size=40, num_layers=2, num_heads=2, hidden=16,
                max_len=48, eos_id=0)
    base.update(kw)
    return pkg_llm.LMConfig(**base)


def lm_params(cfg, seed=0):
    """Random parameters under the llm.model names, every one of them
    away from its initial value (gamma near 1, nonzero betas and
    biases)."""
    rng = np.random.default_rng(seed)
    c, f = cfg.hidden, cfg.hidden * cfg.ffn_mult

    def mk(*s, scale=0.2, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    p = {"lm_embed_weight": mk(cfg.vocab_size, c, scale=0.5),
         "lm_final_ln_gamma": mk(c, scale=0.1, offset=1.0),
         "lm_final_ln_beta": mk(c, scale=0.1)}
    for i in range(cfg.num_layers):
        pre = "lm_block%d_" % i
        for ln in ("ln1", "ln2"):
            p[pre + ln + "_gamma"] = mk(c, scale=0.1, offset=1.0)
            p[pre + ln + "_beta"] = mk(c, scale=0.1)
        p[pre + "qkv_weight"] = mk(3 * c, c)
        p[pre + "qkv_bias"] = mk(3 * c, scale=0.05)
        p[pre + "out_proj_weight"] = mk(c, c)
        p[pre + "out_proj_bias"] = mk(c, scale=0.05)
        p[pre + "fc1_weight"] = mk(f, c)
        p[pre + "fc1_bias"] = mk(f, scale=0.05)
        p[pre + "fc2_weight"] = mk(c, f)
        p[pre + "fc2_bias"] = mk(c, scale=0.05)
    return p


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


# -- the ops -------------------------------------------------------------------

@pytest.mark.parametrize("axis,shape,mean_var", [
    (-1, (2, 5, 16), False), (1, (3, 6, 4), False), (-1, (2, 5, 16), True),
    (1, (3, 6, 4), True)])
def test_layer_norm_matches_jax(axis, shape, mean_var):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    c = shape[axis]
    g = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    b = (0.3 * rng.standard_normal(c)).astype(np.float32)
    kw = dict(axis=axis, eps=1e-3, output_mean_var=mean_var)
    want = jmx.nd.LayerNorm(jmx.nd.array(x), jmx.nd.array(g),
                            jmx.nd.array(b), **kw)
    got = tmx.nd.LayerNorm(*(tmx.nd.array(a, ctx=CPU) for a in (x, g, b)),
                           **kw)
    if not mean_var:
        got, want = [got], [want]
    assert len(got) == len(want) == (3 if mean_var else 1)
    for i, (o, w) in enumerate(zip(got, want)):
        assert o.shape == w.shape
        _close(o.asnumpy(), w.asnumpy(), OP_TOL, f"output {i}")


def test_layer_norm_gradients_match_jax():
    """Through autograd: x, gamma and beta's gradients of a weighted sum
    of the output and of the mean and inverse std."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    g = (1.0 + 0.3 * rng.standard_normal(8)).astype(np.float32)
    b = (0.3 * rng.standard_normal(8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)

    def run(mx, ctx):
        arrs = [mx.nd.array(a, **ctx) for a in (x, g, b)]
        for a in arrs:
            a.attach_grad()
        with mx.autograd.record():
            out, mean, inv = mx.nd.LayerNorm(*arrs, output_mean_var=True)
            loss = (out * mx.nd.array(w, **ctx)).sum() + mean.sum() \
                + inv.sum()
        loss.backward()
        return [a.grad.asnumpy() for a in arrs]

    for got, want, name in zip(run(tmx, {"ctx": CPU}), run(jmx, {}),
                                ("x", "gamma", "beta")):
        _close(got, want, OP_TOL, name)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_embedding_matches_jax_and_clips(dtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 6)).astype(np.float32)
    idx = np.array([[0, 5, 39, 40, 41], [-1, -7, 17, 2, 1000]], np.int64)
    if dtype == "float32":
        idx = idx.astype(np.float32) + np.array([0.0, 0.7, 0.4, 0.0, 0.9],
                                                np.float32)
    else:
        idx = idx.astype(dtype)
    kw = dict(input_dim=40, output_dim=6)
    want = jmx.nd.Embedding(jmx.nd.array(idx, dtype=dtype),
                            jmx.nd.array(w), **kw).asnumpy()
    got = tmx.nd.Embedding(tmx.nd.array(idx, ctx=CPU, dtype=dtype),
                           tmx.nd.array(w, ctx=CPU), **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(
        got.asnumpy(), w[np.clip(np.trunc(idx), 0, 39).astype(int)])


@pytest.mark.parametrize("axis,begin,end", [(-1, 0, 5), (-1, 5, 10),
                                            (1, 2, None), (0, 1, 2)])
def test_slice_axis_matches_jax(axis, begin, end):
    x = np.arange(3 * 4 * 15, dtype=np.float32).reshape(3, 4, 15)
    kw = dict(axis=axis, begin=begin, end=end)
    want = jmx.nd.slice_axis(jmx.nd.array(x), **kw).asnumpy()
    got = tmx.nd.slice_axis(tmx.nd.array(x, ctx=CPU), **kw).asnumpy()
    np.testing.assert_array_equal(got, want)


def test_gluon_layer_norm_names_and_deferred_shape_match_jax():
    def build(mx):
        net = mx.gluon.nn.LayerNorm(epsilon=1e-4)
        return net, net(mx.sym.Variable("data"))

    (tnet, tsym), (jnet, jsym) = _fresh(lambda: build(tmx)), \
        _fresh(lambda: build(jmx))
    assert sorted(tnet.collect_params()) == sorted(jnet.collect_params())
    assert json.loads(tsym.tojson())["nodes"] == \
        json.loads(jsym.tojson())["nodes"]
    assert tsym.infer_shape(data=(2, 7))[0] == \
        [tuple(s) for s in jsym.infer_shape(data=(2, 7))[0]]
    tnet.initialize(ctx=CPU)
    x = np.random.default_rng(4).standard_normal((2, 7)).astype(np.float32)
    out = tnet(tmx.nd.array(x, ctx=CPU))
    assert tnet.gamma.shape == (7,)
    jnet.initialize()
    _close(out.asnumpy(), jnet(jmx.nd.array(x)).asnumpy(), OP_TOL)


# -- the model ------------------------------------------------------------------

def _graph(sym):
    g = json.loads(sym.tojson())
    return {k: g[k] for k in ("nodes", "arg_nodes", "heads")}


def test_lm_symbol_json_shapes_and_types_match_jax():
    tsym = _fresh(lambda: tllm.lm_symbol(_cfg()))
    jsym = _fresh(lambda: jllm.lm_symbol(_cfg(jllm)))
    assert _graph(tsym) == _graph(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    shapes = dict(data=(2, 12), softmax_label=(2, 12))
    targ, tout, _ = tsym.infer_shape(**shapes)
    jarg, jout, _ = jsym.infer_shape(**shapes)
    assert targ == [tuple(s) for s in jarg]
    assert tout == [tuple(s) for s in jout] == [(24, 40)]
    # Embedding's output has the weight's type, whatever the tokens'
    ttypes, touts, _ = tsym.infer_type(data="int32")
    jtypes, jouts, _ = jsym.infer_type(data="int32")
    assert [np.dtype(t) for t in ttypes] == [np.dtype(t) for t in jtypes]
    assert [np.dtype(t) for t in touts] == [np.dtype(t) for t in jouts] \
        == [np.float32]
    # Embedding, 13 ops a block, final LN, head, 2 Reshapes, SoftmaxOutput
    ops = [n for n in json.loads(tsym.tojson())["nodes"] if n["op"] != "null"]
    assert len(ops) == tllm.lm_block_op_count() * 2 + 6


def _nets(cfg_kw=None):
    cfg_kw = cfg_kw or {}
    tnet = _fresh(lambda: tllm.TransformerLM(_cfg(**cfg_kw), prefix="lm_"))
    jnet = _fresh(lambda: jllm.TransformerLM(_cfg(jllm, **cfg_kw),
                                             prefix="lm_"))
    return tnet, jnet


def _jax_block(jnet, values):
    jnet.initialize()
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(values[name]))
    return jnet


@pytest.mark.parametrize("hybrid", [False, True])
def test_transformer_lm_forward_matches_jax(hybrid):
    tnet, jnet = _nets()
    cfg = tnet.cfg
    values = lm_params(cfg)
    assert sorted(tnet.collect_params()) == sorted(jnet.collect_params()) \
        == sorted(values)
    lm_params_from_numpy(values, block=tnet, ctx=CPU)
    _jax_block(jnet, values)
    if hybrid:
        tnet.hybridize()
    x = _tokens(cfg, (2, 12), 5)
    got = tnet(tmx.nd.array(x, ctx=CPU))
    want = jnet(jmx.nd.array(x))
    assert got.shape == want.shape == (2, 12, cfg.vocab_size)
    _close(got.asnumpy(), want.asnumpy(), LM_TOL)


def test_lm_symbol_module_forward_matches_jax():
    cfg = _cfg()
    values = lm_params(cfg)
    x = _tokens(cfg, (2, 12), 6).astype(np.float32)
    y = np.zeros_like(x)

    def run(mx, sym, ctx):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[mx.io.DataDesc("data", x.shape)],
                 label_shapes=[mx.io.DataDesc("softmax_label", y.shape)],
                 for_training=False, grad_req="null")
        mod.set_params({k: mx.nd.array(v) for k, v in values.items()}, {})
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(x)],
                                    label=[mx.nd.array(y)]),
                    is_train=False)
        return mod.get_outputs()[0].asnumpy()

    with CPU:
        got = run(tmx, _fresh(lambda: tllm.lm_symbol(cfg)), CPU)
    want = run(jmx, _fresh(lambda: jllm.lm_symbol(_cfg(jllm))), jmx.cpu())
    assert got.shape == want.shape == (24, cfg.vocab_size)
    _close(got, want, LM_TOL)


# -- the decode plane ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "torch", "ndarray"])
def test_stack_lm_params_shapes_and_errors(kind):
    cfg = _cfg()
    values = lm_params(cfg)
    conv = {"numpy": lambda v: v, "torch": torch.from_numpy,
            "ndarray": lambda v: tmx.nd.array(v, ctx=CPU)}[kind]
    args = {k: conv(v) for k, v in values.items()}
    sp = tllm.stack_lm_params(args, cfg, ctx=CPU)
    L, C = cfg.num_layers, cfg.hidden
    assert sp["embed"].shape == (cfg.vocab_size, C)
    assert sp["layers"]["qkv_weight"].shape == (L, 3 * C, C)
    assert sp["layers"]["fc2_weight"].shape == (L, C, cfg.ffn_mult * C)
    want = jllm.stack_lm_params(values, _cfg(jllm))
    assert sorted(sp["layers"]) == sorted(want["layers"])
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(sp["layers"][k].numpy(),
                                      np.asarray(v))
    broken = dict(args)
    broken.pop("lm_block0_qkv_weight")
    with pytest.raises(tmx.MXNetError, match="qkv_weight"):
        tllm.stack_lm_params(broken, cfg, ctx=CPU)


class _JaxPlane:
    """The JAX package's decode programs on the same parameters."""

    def __init__(self, cfg, values, slots):
        from incubator_mxnet_tpu import fused
        self.progs = jllm.DecodePrograms(
            cfg, jllm.stack_lm_params(values, cfg), label="t-port")
        self.ck, self.cv = fused.reown_for_donation(
            jllm.init_kv_cache(cfg, slots))

    def prefill(self, tokens, slot, length):
        import jax.numpy as jnp
        self.ck, self.cv, tok, logits = self.progs.prefill(
            self.progs.params, self.ck, self.cv, jnp.asarray(tokens),
            jnp.int32(slot), jnp.int32(length))
        return int(tok), np.asarray(logits)

    def step(self, tokens, positions):
        import jax.numpy as jnp
        self.ck, self.cv, tok, logits = self.progs.step(
            self.progs.params, self.ck, self.cv,
            jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32))
        return np.asarray(tok), np.asarray(logits)


def test_decode_programs_match_jax():
    """Prefills into two slots and decode steps: logits, tokens and the
    whole cache arrays (the padding's rows and untouched slots too)."""
    cfg = _cfg()
    values = lm_params(cfg)
    slots = 3
    ref = _JaxPlane(_cfg(jllm), values, slots)
    progs = tllm.DecodePrograms(
        cfg, tllm.stack_lm_params(values, cfg, ctx=CPU), label="t-port")
    ck, cv = tllm.init_kv_cache(cfg, slots, CPU)

    def caches(what):
        _close(ck.numpy(), np.asarray(ref.ck), LM_TOL, what + " cache_k")
        _close(cv.numpy(), np.asarray(ref.cv), LM_TOL, what + " cache_v")

    tokens = np.zeros((slots,), np.int32)
    positions = np.zeros((slots,), np.int32)
    for slot, n, tb in ((1, 6, 8), (2, 3, 4)):
        prompt = np.zeros((1, tb), np.int32)
        prompt[0, :n] = _tokens(cfg, n, 10 + slot)
        want_tok, want = ref.prefill(prompt, slot, n)
        _, _, tok, logits = progs.prefill(progs.params, ck, cv, prompt,
                                          slot, n)
        assert logits.shape == (cfg.vocab_size,)
        _close(logits.numpy(), want, LM_TOL, f"prefill logits slot {slot}")
        assert int(tok) == want_tok
        caches(f"prefill slot {slot}")
        tokens[slot], positions[slot] = want_tok, n
        for _ in range(3):
            want_tok, want = ref.step(tokens, positions)
            _, _, tok, logits = progs.step(progs.params, ck, cv, tokens,
                                           positions)
            assert logits.shape == (slots, cfg.vocab_size)
            _close(logits.numpy(), want, LM_TOL, "step logits")
            np.testing.assert_array_equal(tok.numpy(), want_tok)
            caches("step")
            tokens = want_tok.astype(np.int32)
            positions = positions + 1
    assert progs.program_count() == 3   # buckets 8 and 4, and the step


def test_prefill_matches_the_gluon_forward():
    """The serving plane is the function the training graph computes:
    prefill's next-token logits equal the gluon forward at the last
    position."""
    tnet, _ = _nets()
    cfg = tnet.cfg
    values = lm_params(cfg, seed=7)
    lm_params_from_numpy(values, block=tnet, ctx=CPU)
    tnet.hybridize()
    prompt = _tokens(cfg, (1, 8), 8)
    progs = tllm.DecodePrograms(
        cfg, tllm.stack_lm_params(values, cfg, ctx=CPU))
    ck, cv = tllm.init_kv_cache(cfg, 2, CPU)
    _, _, tok, logits = progs.prefill(progs.params, ck, cv, prompt, 0, 8)
    want = tnet(tmx.nd.array(prompt, ctx=CPU)).asnumpy()[0, 7]
    _close(logits.numpy(), want, LM_TOL)
    assert int(tok) == int(np.argmax(want))


def test_decode_step_matches_prefill_of_the_extended_prompt():
    cfg = _cfg()
    values = lm_params(cfg, seed=9)
    progs = tllm.DecodePrograms(
        cfg, tllm.stack_lm_params(values, cfg, ctx=CPU))
    prompt = _tokens(cfg, (1, 6), 9)
    ck, cv = tllm.init_kv_cache(cfg, 3, CPU)
    _, _, tok, _ = progs.prefill(progs.params, ck, cv,
                                 np.pad(prompt, ((0, 0), (0, 2))), 1, 6)
    toks = np.zeros((3,), np.int32)
    poss = np.zeros((3,), np.int32)
    toks[1], poss[1] = int(tok), 6
    _, _, _, logits_step = progs.step(progs.params, ck, cv, toks, poss)
    ext = np.concatenate([prompt, [[int(tok)]]], axis=1)
    ck2, cv2 = tllm.init_kv_cache(cfg, 3, CPU)
    _, _, _, logits_pre = progs.prefill(
        progs.params, ck2, cv2, np.pad(ext, ((0, 0), (0, 1))), 0, 7)
    _close(logits_step.numpy()[1], logits_pre.numpy(), LM_TOL)
