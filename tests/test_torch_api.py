"""The port's public flags against the JAX package's: which checkpoint
``load`` / ``_load`` / ``generate`` pick from the same flags, the offline
random checkpoint ``load`` writes when none is on disk, the ``verbose``
prompt banner, and the server's command line.

Except in the offline tests, ``_load`` is stubbed on both sides to return
its ``model_path``, and ``generate_text`` to return nothing, so no model is
built: only the selection and the printed text are compared.  The offline
tests build 2-layer models of the ``tiny`` preset's widths in a temporary
working directory.
"""

import inspect
import json
import os

import pytest

pytest.importorskip("torch")

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.serve import server as TSERVER  # noqa: E402


@pytest.fixture
def stubbed_load(monkeypatch):
    """Both packages' ``load`` return the checkpoint path they chose."""
    for mod in (JAPI, TAPI):
        monkeypatch.setattr(mod, "_load", lambda model_path, **kw: model_path)
    monkeypatch.setattr(os.path, "exists", lambda path: True)


@pytest.mark.parametrize("flags", [
    {},
    {"quantize_model": True},
    {"quantize_cache": True},
    {"quantize_model": True, "quantize_cache": True},
])
def test_load_picks_the_jax_checkpoint(stubbed_load, flags):
    """The same flags pick the same checkpoint: the unquantized model unless
    ``quantize_model``.  The port's ``blind_model`` defaults to the text
    model, its only one until vision is ported, so the JAX side names it."""
    want = JAPI.load(blind_model=True, **flags)
    assert TAPI.load(**flags) == want
    assert TAPI.load(blind_model=True, **flags) == want
    assert want == (JAPI.PATH_QUANTIZED_PHI3_BLIND if flags.get("quantize_model")
                    else JAPI.PATH_ORIGINAL_PHI3_BLIND)


def test_load_default_is_the_unquantized_text_checkpoint():
    """``_load()`` with no path reads the unquantized checkpoint, as the JAX
    ``_load`` does; the JAX default is the vision one, and the port's text
    twin stands in for it until vision is ported."""
    default = inspect.signature(TAPI._load).parameters["model_path"].default
    assert inspect.signature(JAPI._load).parameters["model_path"].default == JAPI.PATH_ORIGINAL_PHI3_VISION
    assert default == TAPI.PATH_ORIGINAL_PHI3_BLIND == JAPI.PATH_ORIGINAL_PHI3_BLIND


# The tiny preset's widths (core/config.py _TINY) for PHI3V_TPU_RANDOM_OVERRIDES.
TINY_WIDTHS = {"vocab_size": 512, "hidden_size": 128, "intermediate_size": 256,
               "num_attention_heads": 4, "num_key_value_heads": 2}


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """A working directory with no checkpoint, the random-checkpoint
    variables for a 2-layer tiny-width model, no download on the JAX side
    (its ``download_and_convert`` raises), and its vision pair already
    present so that its ``_setup`` writes no full-size CLIP."""
    monkeypatch.setenv("PHI3V_TPU_ALLOW_RANDOM", "1")
    monkeypatch.setenv("PHI3V_TPU_RANDOM_LAYERS", "2")
    monkeypatch.setenv("PHI3V_TPU_RANDOM_OVERRIDES", json.dumps(TINY_WIDTHS))

    def no_network(hub, *a, **kw):
        raise OSError(f"no network: {hub} is not downloaded in the tests")

    monkeypatch.setattr(JAPI.W, "download_and_convert", no_network)

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        monkeypatch.chdir(path)
        return path

    return workdir


def _shape(cfg):
    q = cfg.quantized
    return (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
            cfg.num_attention_heads, cfg.num_key_value_heads, None if q is None else (q.group_size, q.bits))


@pytest.mark.parametrize("quantize_model", [False, True])
def test_load_writes_a_random_checkpoint_offline(offline, quantize_model):
    """With no checkpoint on disk and ``PHI3V_TPU_ALLOW_RANDOM=1``, both
    packages' ``load`` write a random 2-layer pair of the overridden widths
    and return a model of it (4-bit with ``quantize_model``); the port also
    loads the pair the JAX ``_setup`` wrote (the shared format)."""
    offline("jax")
    for d in (JAPI.PATH_ORIGINAL_PHI3_VISION, JAPI.PATH_QUANTIZED_PHI3_VISION):
        os.makedirs(d)
    jlm, _ = JAPI.load(blind_model=True, quantize_model=quantize_model)
    from_jax, _ = TAPI.load(quantize_model=quantize_model, device="cpu")
    offline("torch")
    tlm, proc = TAPI.load(quantize_model=quantize_model, device="cpu")
    assert os.path.isdir(TAPI.PATH_ORIGINAL_PHI3_BLIND) and os.path.isdir(TAPI.PATH_QUANTIZED_PHI3_BLIND)
    want = (2, 128, 256, 512, 4, 2, (64, 4) if quantize_model else None)
    assert _shape(jlm.cfg) == _shape(from_jax.cfg) == _shape(tlm.cfg) == want
    assert not tlm.cfg.has_vision and proc is not None


def test_load_without_a_checkpoint_raises_offline(offline, monkeypatch):
    """Without ``PHI3V_TPU_ALLOW_RANDOM`` both packages raise
    ``RuntimeError`` and write nothing."""
    monkeypatch.delenv("PHI3V_TPU_ALLOW_RANDOM")
    offline("none")
    with pytest.raises(RuntimeError, match="PHI3V_TPU_ALLOW_RANDOM"):
        JAPI.load(blind_model=True)
    with pytest.raises(RuntimeError, match="PHI3V_TPU_ALLOW_RANDOM"):
        TAPI.load(device="cpu")
    assert not os.path.exists(TAPI.PATH_ORIGINAL_PHI3_BLIND)


def test_generate_loads_what_the_jax_generate_loads(monkeypatch):
    """``generate`` without ``preload`` passes the JAX defaults on to ``load``."""
    seen = {}

    def recorder(name):
        def load(**kw):
            seen[name] = kw
            return None, None
        return load

    for name, mod in (("jax", JAPI), ("torch", TAPI)):
        monkeypatch.setattr(mod, "load", recorder(name))
        monkeypatch.setattr(mod, "generate_text", lambda *a, **kw: None)
    JAPI.generate("Hi", blind_model=True, verbose=False)
    TAPI.generate("Hi", verbose=False)
    assert seen["torch"]["quantize_model"] is seen["jax"]["quantize_model"] is False
    assert seen["torch"]["blind_model"] is seen["jax"]["blind_model"] is True
    assert seen["torch"]["quantize_cache"] is seen["jax"]["quantize_cache"] is False


@pytest.mark.parametrize("prompt, template", [
    ("Hi there", True),
    (["Hi", " Yo "], True),
    (["Hi", " Yo "], False),
    ("Hi", False),
])
def test_verbose_banner_matches_jax(monkeypatch, capsys, prompt, template):
    """``generate(..., verbose=True)`` prints the JAX package's banner; the
    prompt handed to the model is the same on both sides."""
    handed = {}
    for name, mod in (("jax", JAPI), ("torch", TAPI)):
        monkeypatch.setattr(mod, "generate_text",
                            lambda lm, proc, p, name=name, **kw: handed.setdefault(name, p))
    printed = []
    for mod in (JAPI, TAPI):
        mod.generate(prompt, preload=(None, None), verbose=True, apply_chat_template=template)
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0]
    assert printed[0].startswith("*** Prompt ***\n") and "\n*** Images ***\nNone\n" in printed[0]
    assert handed["torch"] == handed["jax"]


def test_server_parser_takes_the_jax_flags(monkeypatch):
    """``--blind --quantize`` parse and reach ``load`` as the JAX server
    passes them; without ``--quantize`` the unquantized checkpoint."""
    a = TSERVER.build_parser().parse_args(["--blind", "--quantize", "--port", "8123"])
    assert a.blind and a.quantize and a.port == 8123
    served = []
    monkeypatch.setattr(TSERVER, "serve", lambda *a, **kw: served.append(kw))
    TSERVER.main(["--blind", "--quantize"])
    TSERVER.main(["--continuous", "--paged"])
    assert served[0]["blind_model"] and served[0]["quantize_model"] is True
    assert served[1]["quantize_model"] is False and served[1]["continuous"] and served[1]["paged"]
