"""The port's agent toolchain and embeddings (``agent/*``, ``models/gte.py``,
``api.execute``, ``generate(enable_api=)``) against the JAX package's, on
the CPU (modelled on tests/test_periphery.py and
tests/test_parity_vision_gte.py).

Nothing here reaches the network: ``HF_HUB_OFFLINE`` is set for the port,
and the JAX package's fetches (``datasets``, ``huggingface_hub``) find their
modules missing, so both fall back to the built-in snippets and the lexical
hashing embedder, loudly.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import reference_numpy as ref  # noqa: E402
from test_torch_model import make_checkpoint  # noqa: E402
from test_torch_speculative import one_thread  # noqa: E402,F401  (autouse: one torch thread)

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu.agent import agent as JAG  # noqa: E402
from phi_3_vision_mlx_tpu.agent import external as JX  # noqa: E402
from phi_3_vision_mlx_tpu.agent import sandbox as JSB  # noqa: E402
from phi_3_vision_mlx_tpu.agent import tools as JT  # noqa: E402
from phi_3_vision_mlx_tpu.models import gte as JG  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.agent import agent as TAG  # noqa: E402
from phi_3_vision_mlx_tpu_torch.agent import external as TX  # noqa: E402
from phi_3_vision_mlx_tpu_torch.agent import sandbox as TSB  # noqa: E402
from phi_3_vision_mlx_tpu_torch.agent import tools as TT  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_f32_tree  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import gte as TG  # noqa: E402


API_PROMPTS = ["Transcribe youtube video <|api_input|> http://x.test/v",
               "Text to speech <|api_input|> hello there",
               "Draw a picture: text to image <|api_input|> a red apple"]
F32_ATOL = 1e-5


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """No network for either package, and a scratch working directory (the
    agent log, plots, the ``models/gte`` lookup)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(sys.modules, "datasets", None)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    monkeypatch.chdir(tmp_path)


# -- sandbox ----------------------------------------------------------------------


@pytest.mark.parametrize("code", [
    "```python\nprint(21*2)\n```",
    "```python\nraise ValueError('x')\n```",
    "no code here",
    "```python\nprint('a')\n```\nand\n```python\nprint('b')\n```",
    "```python\nprint('<|api_output|>' + 'nofile.txt')\n```",
], ids=["print", "raise", "none", "two-blocks", "api-output"])
def test_execute_matches_jax(code):
    got = TAPI.execute([code], file_prefix=3, verbose=False)
    assert got == JAPI.execute([code], file_prefix=3, verbose=False)
    assert TSB.extract_code(code) == JSB.extract_code(code)


def test_execute_claims_announced_file_and_plots(tmp_path, capsys):
    """An ``<|api_output|>`` file moves under the run's prefix; a savefig
    becomes ``{prefix}.png`` (the plot file name only: matplotlib need not
    be installed, the run then reports its error as the JAX one does)."""
    (tmp_path / "art.txt").write_text("x")
    code = "```python\nprint('<|api_output|>art.txt')\n```"
    out = TAPI.execute(code, file_prefix=7, verbose=True)
    assert out["files"] == ["7_0_art.txt"] and (tmp_path / "7_0_art.txt").exists()
    assert "*** Execution ***" in capsys.readouterr().out
    plot = "```python\nimport matplotlib.pyplot as plt\nplt.plot([1, 2])\nplt.savefig('x.png')\n```"
    got = TSB.run_code(plot, "p")
    want = JSB.run_code(plot, "p")
    assert (got.code, got.artifact, got.stderr is None) == (want.code, want.artifact, want.stderr is None)
    assert "plt.show()" in got.code


# -- tools -------------------------------------------------------------------------


def test_add_code_and_add_text_match_jax(tmp_path):
    assert TT.add_code("p", None) == JT.add_code("p", None) == "p"
    assert TT.add_code("p", ["a = 1", "b"]) == JT.add_code("p", ["a = 1", "b"])
    (tmp_path / "ctx.txt").write_text('The "context" text.')
    for prompt in ("What is it? @ ctx.txt", ["Q1 @ ctx.txt", "Q2 @ plain words"]):
        assert TT.add_text(prompt) == JT.add_text(prompt)


def test_hash_embedder_and_vdb_match_jax():
    texts = ["Transcribe youtube video for me", "Text to speech conversion", "", "A b C d 42"]
    got, want = TG.HashEmbedder()(texts), JG.HashEmbedder()(texts)
    np.testing.assert_array_equal(got, want)
    assert TG._list_api == JG._list_api
    for n_line in (1, -1):
        tv, jv = TG.VDB(embed=TG.HashEmbedder(), n_line=n_line), JG.VDB(embed=JG.HashEmbedder(), n_line=n_line)
        np.testing.assert_array_equal(tv.item_embeds, jv.item_embeds)
        assert tv(texts, n_topk=2) == jv(texts, n_topk=2)
    hits = TG.VDB(embed=TG.HashEmbedder())(["Transcribe youtube video for me"])
    assert "youtube" in hits[0][0].lower()


def test_get_api_and_rag_offline_match_jax(capsys):
    for prompt in API_PROMPTS + [API_PROMPTS[:2]]:
        got = TT.get_api(prompt, verbose=False)
        assert got == JT.get_api(prompt, verbose=False)
    assert "http://x.test/v" in got[0] and "{prompt}" not in got[0]
    assert "lexical-hash fallback" in capsys.readouterr().err
    for prompt in ("How do I plot a sine wave?", ["Text to speech please", "youtube"]):
        assert TT.rag(prompt, n_topk=1) == JT.rag(prompt, n_topk=1)


def test_generate_enable_api_returns_the_snippet(capsys):
    """The ``<|api_input|>`` shortcut runs before any model is loaded, so
    no checkpoint and no card are needed."""
    prompt = 'Text to speech <|api_input|> "good morning"'
    got = TAPI.generate(prompt, enable_api=True)
    assert got == JAPI.generate(prompt, enable_api=True)
    assert len(got) == 1 and '"good morning"' in got[0] and "parler" in got[0]
    assert "*** Obtained API Codes ***" in capsys.readouterr().out


def test_external_tools_raise_offline():
    for mod in (TX, JX):
        with pytest.raises(RuntimeError, match="network"):
            mod.mistral_api("hi", history=[], verbose=False)
        with pytest.raises(RuntimeError, match="network"):
            mod.bark_api("hi", verbose=False)


# -- the Agent DSL ----------------------------------------------------------------


def _probe_tools(calls):
    def generate(prompt, images=None):
        calls.append(prompt)
        return f"echo: {prompt}"

    def execute(responses, step):
        return {"files": [f"f{step}"], "codes": [responses]}

    return {"generate": generate, "execute": execute}


@pytest.mark.parametrize("enable_api", [False, True])
def test_agent_dsl_matches_jax(tmp_path, enable_api):
    """The same toolchain (quote rewriting, kwargs filtered by signature,
    tuple and dict returns, ``return`` list, the log, ``end``) in both."""
    chain = """
        prompt = add_code(prompt, codes)
        responses = generate(prompt, images)
        files, codes = execute(responses, step)
        return responses, files, codes
        """
    outs, logs = [], []
    for mod in (JAG, TAG):
        calls = []
        agent = mod.Agent(toolchain=chain, enable_api=enable_api, tools=_probe_tools(calls),
                          preload=("m", "p"))
        first = agent('Draw "a red apple"')
        second = agent("and again")
        agent.end()
        outs.append((first, second, calls, agent.list_outs))
        logs.append(json.load(open(tmp_path / "agent_log.json")))
    assert outs[1] == outs[0]
    assert logs[1] == logs[0]
    assert ("<|api_input|>" in outs[1][2][0]) == enable_api


def test_agent_rejects_unknown_tools_and_hot_swaps():
    agent = TAG.Agent(toolchain="responses = generate(prompt, images)", enable_api=False,
                      tools=_probe_tools([]), preload=("m", "p"))
    assert agent("hello") == {"responses": "echo: hello", "files": None}
    agent.set_toolchain("responses = generate(prompt, images)\nreturn responses")
    assert agent.list_outs == ["responses"]
    with pytest.raises(KeyError, match="unknown tool"):
        agent.set_toolchain("x = nope(prompt)")
    assert set(TAG._default_registry()) == set(JAG._default_registry())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_checkpoint(tmp_path_factory.mktemp("ckpt"), "tiny")


def test_agent_default_toolchain_matches_jax(ckpt, tmp_path):
    """The default toolchain through the real ``generate`` and ``execute``
    of each package on one checkpoint: the same responses, files and log."""
    jpre = JAPI._load(ckpt)
    tpre = TAPI._load(ckpt, device="cpu")
    results = []
    for mod, pre in ((JAG, jpre), (TAG, tpre)):
        agent = mod.Agent(preload=pre, max_tokens=12, verbose=False, stream=False, mute=True)
        results.append((agent("Say something."), json.load(open(tmp_path / "agent_log.json"))))
    assert results[1] == results[0]
    (out, log) = results[1]
    assert out["files"] is None and isinstance(out["responses"], list)  # no code block: [None] -> None


def test_agent_loads_without_preload(monkeypatch):
    """Without ``preload`` the agent loads through ``api.load`` with its
    flags (here a stand-in that records them)."""
    seen = {}
    monkeypatch.setattr(TAPI, "load", lambda **kw: seen.update(kw) or ("m", "p"))
    agent = TAG.Agent(blind_model=True, device="cpu", tools=_probe_tools([]))
    assert seen == {"blind_model": True, "device": "cpu"} and agent.kwargs["preload"] == ("m", "p")


# -- GTE --------------------------------------------------------------------------

GCFG_J = JG.GteConfig(dim=64, num_attention_heads=4, num_hidden_layers=2, vocab_size=97,
                      max_position_embeddings=32)
GCFG_T = TG.GteConfig(**{f: getattr(GCFG_J, f) for f in ("dim", "num_attention_heads",
                                                         "num_hidden_layers", "vocab_size",
                                                         "layer_norm_eps", "max_position_embeddings")})


def _gcfg_dict():
    return {"layer_norm_eps": GCFG_J.layer_norm_eps, "num_attention_heads": GCFG_J.num_attention_heads}


def _gte_ref_weights(params):
    """The JAX tree -> tests/reference_numpy.bert_encode's weight dict."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    emb, lay = params["embeddings"], params["layers"]
    layers = [{
        **{f"{k}_w": f32(lay[k]["weight"][i]).T for k in ("q", "k", "v", "o", "ff1", "ff2")},
        **{f"{k}_b": f32(lay[k]["bias"][i]) for k in ("q", "k", "v", "o", "ff1", "ff2")},
        **{f"{k}_{x}": f32(lay[k][n][i]) for k in ("ln1", "ln2") for x, n in (("w", "weight"), ("b", "bias"))},
    } for i in range(GCFG_J.num_hidden_layers)]
    return {"word_emb": f32(emb["word"]), "pos_emb": f32(emb["position"]),
            "ttype_emb": f32(emb["token_type"]), "emb_ln_w": f32(emb["norm"]["weight"]),
            "emb_ln_b": f32(emb["norm"]["bias"]), "layers": layers}


@pytest.fixture(scope="module")
def gte_pair():
    params = JG.init_gte_params(GCFG_J, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(  # non-trivial norms and biases
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    ids = rng.integers(1, GCFG_J.vocab_size, (3, 12)).astype(np.int32)
    ttype = rng.integers(0, 2, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    return params, from_numpy_f32_tree(params), ids, ttype, mask


def test_gte_forward_matches_jax_and_reference(gte_pair):
    jparams, tparams, ids, ttype, mask = gte_pair
    want = np.asarray(JG.gte_forward(jparams, GCFG_J, jnp.asarray(ids), jnp.asarray(ttype),
                                     jnp.asarray(mask)))
    got = TG.gte_forward(tparams, GCFG_T, ids, ttype, mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    w = _gte_ref_weights(jparams)
    np.testing.assert_allclose(got.numpy(), ref.bert_encode(_gcfg_dict(), w, ids, ttype, mask),
                               rtol=1e-4, atol=1e-4)
    pooled = TG.average_pool(got, mask)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(JG.average_pool(jnp.asarray(want), jnp.asarray(mask))),
                               rtol=0, atol=F32_ATOL)
    emb = (pooled / torch.linalg.norm(pooled, dim=1, keepdim=True)).numpy()
    np.testing.assert_allclose(emb, ref.gte_embed(_gcfg_dict(), w, ids, ttype, mask), rtol=1e-4, atol=1e-4)


def test_gte_npz_round_trips_between_packages(gte_pair, tmp_path):
    jparams, tparams, ids, ttype, mask = gte_pair
    JG.save_gte_npz(jparams, GCFG_J, str(tmp_path / "j.npz"))
    from_jax = TG.load_gte_npz(str(tmp_path / "j.npz"), GCFG_T)
    TG.save_gte_npz(tparams, GCFG_T, str(tmp_path / "t.npz"))
    from_port = JG.load_gte_npz(str(tmp_path / "t.npz"), GCFG_J)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(from_port)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    flat_t = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), from_jax))
    for a, b in zip(jax.tree_util.tree_leaves(jparams), flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
    bad = dict(np.load(tmp_path / "t.npz"))
    del bad["pooler.bias"]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(KeyError, match="pooler.bias"):
        TG.load_gte_npz(str(tmp_path / "bad.npz"), GCFG_T)


class _Tokenizer:
    """A BERT-tokenizer stand-in: characters to ids, padded to the longest."""

    def __call__(self, texts, return_tensors, padding, truncation, max_length):
        rows = [[1 + ord(c) % 90 for c in t][:max_length] or [1] for t in texts]
        n = max(len(r) for r in rows)
        ids = np.array([r + [0] * (n - len(r)) for r in rows], np.int64)
        mask = np.array([[1] * len(r) + [0] * (n - len(r)) for r in rows], np.int64)
        return {"input_ids": ids, "attention_mask": mask, "token_type_ids": np.zeros_like(ids)}


def test_gte_model_and_vdb_match_jax(gte_pair, tmp_path):
    """``GteModel`` from a local directory (config.json + model.npz) embeds
    as the JAX one does, and routes a ``VDB`` the same way."""
    jparams = gte_pair[0]
    d = tmp_path / "gte"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(
        {"dim": 64, "num_attention_heads": 4, "num_hidden_layers": 2, "vocab_size": 97,
         "max_position_embeddings": 32, "architectures": ["Bert"]}))
    JG.save_gte_npz(jparams, GCFG_J, str(d / "model.npz"))
    tm = TG.GteModel(str(d), tokenizer=_Tokenizer(), device="cpu")
    jm = JG.GteModel(str(d), tokenizer=_Tokenizer())
    assert tm.cfg == GCFG_T
    texts = ["a short one", "Transcribe youtube video", "x" * 40]
    got = tm(texts)
    np.testing.assert_allclose(got, jm(texts), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-6)
    assert TG.VDB(embed=tm)(texts) == JG.VDB(embed=jm)(texts)


def test_gte_model_needs_a_card_or_cpu(gte_pair, tmp_path, capsys):
    """``GteModel`` runs on ``cuda`` unless told otherwise, and raises with
    no card; the default embedder then says it falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.GteModel(str(tmp_path), tokenizer=_Tokenizer())
    assert isinstance(TG.default_embedder(str(tmp_path / "absent")), TG.HashEmbedder)
    assert "lexical-hash fallback" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="HF_HUB_OFFLINE"):  # no weights, nothing fetched
        TG.GteModel(str(tmp_path / "absent"), tokenizer=_Tokenizer(), device="cpu")


def test_init_gte_params_layout(gte_pair):
    """The port's random init has the JAX tree's structure and shapes."""
    tparams = TG.init_gte_params(GCFG_T, torch.Generator().manual_seed(0))
    jshapes = jax.tree_util.tree_map(np.shape, gte_pair[0])
    tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams)
    assert tshapes == jshapes
    out = TG.gte_forward(tparams, GCFG_T, *gte_pair[2:])
    assert out.shape == (3, 12, 64) and torch.isfinite(out).all()
