"""The port's public flags against the JAX package's: which checkpoint
``load`` / ``_load`` / ``generate`` pick from the same flags (the vision
model by default), the offline random checkpoint pairs ``_setup`` writes
when none is on disk, the ``verbose`` prompt banner and the image prompt's
template, and the server's command line.

Except in the offline tests, ``_load`` is stubbed on both sides to return
its ``model_path``, and ``generate_text`` to return nothing, so no model is
built: only the selection and the printed text are compared.  The offline
tests build 2-layer models of the ``tiny`` preset's widths in a temporary
working directory.
"""

import inspect
import json
import os
import socket

import pytest

pytest.importorskip("torch")

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import config as TC  # noqa: E402
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
    """The same flags pick the same checkpoint: the vision model unless
    ``blind_model``, the unquantized one unless ``quantize_model``."""
    want = JAPI.load(**flags)
    assert TAPI.load(**flags) == want
    assert want == (JAPI.PATH_QUANTIZED_PHI3_VISION if flags.get("quantize_model")
                    else JAPI.PATH_ORIGINAL_PHI3_VISION)
    blind = JAPI.load(blind_model=True, **flags)
    assert TAPI.load(blind_model=True, **flags) == blind
    assert blind == (JAPI.PATH_QUANTIZED_PHI3_BLIND if flags.get("quantize_model")
                     else JAPI.PATH_ORIGINAL_PHI3_BLIND)


def test_load_default_is_the_unquantized_text_checkpoint():
    """``_load()`` with no path reads the unquantized vision checkpoint, the
    JAX ``_load``'s default (the text checkpoint stood in for it before the
    vision path was ported)."""
    default = inspect.signature(TAPI._load).parameters["model_path"].default
    assert inspect.signature(JAPI._load).parameters["model_path"].default == JAPI.PATH_ORIGINAL_PHI3_VISION
    assert default == TAPI.PATH_ORIGINAL_PHI3_VISION == JAPI.PATH_ORIGINAL_PHI3_VISION
    assert inspect.signature(TAPI.load).parameters["blind_model"].default is False
    assert inspect.signature(JAPI.load).parameters["blind_model"].default is False


# The tiny preset's widths (core/config.py _TINY) for PHI3V_TPU_RANDOM_OVERRIDES.
TINY_WIDTHS = {"vocab_size": 512, "hidden_size": 128, "intermediate_size": 256,
               "num_attention_heads": 4, "num_key_value_heads": 2}


# The tiny_vision preset's CLIP tower, which the port's offline checkpoints
# of the vision preset get in place of the full-size one.
SMALL_TOWER = dict(vision=TC.ClipVisionConfig(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                                              num_hidden_layers=2), image_dim_out=64)


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """A working directory with no checkpoint, the random-checkpoint
    variables for a 2-layer tiny-width model, no network (sockets refuse to
    connect; the JAX ``download_and_convert`` raises), the port's random
    vision checkpoint with ``SMALL_TOWER`` (the variables size the decoder
    only), and the JAX side's vision pair already present so that its
    ``_setup`` writes no full-size CLIP."""
    monkeypatch.setenv("PHI3V_TPU_ALLOW_RANDOM", "1")
    monkeypatch.setenv("PHI3V_TPU_RANDOM_LAYERS", "2")
    monkeypatch.setenv("PHI3V_TPU_RANDOM_OVERRIDES", json.dumps(TINY_WIDTHS))

    def no_network(*a, **kw):
        raise OSError(f"no network in the tests: {a[:2]}")

    monkeypatch.setattr(JAPI.W, "download_and_convert", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    create = TAPI.W.create_random_checkpoint

    def small_tower(path, preset_name, **overrides):
        if preset_name == "phi35_vision":
            overrides.update(SMALL_TOWER)
        return create(path, preset_name, **overrides)

    monkeypatch.setattr(TAPI.W, "create_random_checkpoint", small_tower)

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
    from_jax, _ = TAPI.load(blind_model=True, quantize_model=quantize_model, device="cpu")
    offline("torch")
    tlm, proc = TAPI.load(blind_model=True, quantize_model=quantize_model, device="cpu")
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
    JAPI.generate("Hi", verbose=False)
    TAPI.generate("Hi", verbose=False)
    assert seen["torch"]["quantize_model"] is seen["jax"]["quantize_model"] is False
    assert seen["torch"]["blind_model"] is seen["jax"]["blind_model"] is False
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


class Named:
    """An image stand-in with ``.convert``, printed by its name."""

    def __init__(self, name):
        self.name = name

    def convert(self, mode):
        return self

    def __str__(self):
        return self.name


@pytest.mark.parametrize("n_images, template", [(1, True), (2, True), (2, False)])
def test_image_prompt_template_matches_jax(monkeypatch, capsys, n_images, template):
    """With images, ``generate`` prints them in the banner, puts an
    ``<|image_i|>`` line per image before the text, and hands the images on,
    as the JAX package does."""
    handed = {}
    for name, mod in (("jax", JAPI), ("torch", TAPI)):
        monkeypatch.setattr(mod, "generate_text", lambda lm, proc, p, name=name, **kw: handed.setdefault(
            name, (p, kw["images"])))
    images = [Named(f"img{i}.png") for i in range(n_images)]
    printed = []
    for mod in (JAPI, TAPI):
        mod.generate(" Compare. ", images=images, preload=(None, None), verbose=True,
                     apply_chat_template=template)
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] and "*** Images ***\nimg0.png\n" in printed[0]
    assert handed["torch"] == handed["jax"]
    if template:
        assert handed["torch"][0].startswith("<|user|>\n<|image_1|>\n")
    assert handed["torch"][1] == images
    assert TAPI._load_image is TAPI.fetch_image and TAPI._load_text is TAPI.fetch_text


def test_setup_writes_both_random_pairs_offline(offline):
    """The port's ``_setup`` writes the text and the vision pair, each
    unquantized and 4-bit, with no network; ``load()`` then gives the
    vision model and its processor, ``load(blind_model=True)`` the text
    model."""
    offline("setup")
    TAPI._setup()
    for path in (TAPI.PATH_ORIGINAL_PHI3_BLIND, TAPI.PATH_QUANTIZED_PHI3_BLIND,
                 TAPI.PATH_ORIGINAL_PHI3_VISION, TAPI.PATH_QUANTIZED_PHI3_VISION):
        assert os.path.isfile(f"{path}/config.json"), path
    vlm, vproc = TAPI.load(device="cpu")
    assert vlm.cfg.has_vision and vlm.model_path == TAPI.PATH_ORIGINAL_PHI3_VISION
    assert type(vproc).__name__ == "Phi3VProcessor"
    assert _shape(vlm.cfg) == (2, 128, 256, 512, 4, 2, None)
    qlm, _ = TAPI.load(quantize_model=True, device="cpu")
    assert qlm.cfg.has_vision and qlm.cfg.quantized.bits == 4
    blm, _ = TAPI.load(blind_model=True, device="cpu")
    assert not blm.cfg.has_vision


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


def test_server_blind_flag_selects_the_model(stubbed_load, monkeypatch):
    """``--blind`` serves the text model, its absence the vision model: the
    checkpoint ``serve`` loads is the one the JAX server's flags pick."""
    loaded = []
    monkeypatch.setattr(TSERVER, "serve", lambda *a, **kw: loaded.append(TAPI.load(
        blind_model=kw["blind_model"], quantize_model=kw["quantize_model"])))
    for argv in ([], ["--blind"], ["--quantize"], ["--blind", "--quantize"]):
        TSERVER.main(argv)
        a = TSERVER.build_parser().parse_args(argv)
        assert loaded[-1] == JAPI.load(blind_model=a.blind, quantize_model=a.quantize)
    assert loaded == [JAPI.PATH_ORIGINAL_PHI3_VISION, JAPI.PATH_ORIGINAL_PHI3_BLIND,
                      JAPI.PATH_QUANTIZED_PHI3_VISION, JAPI.PATH_QUANTIZED_PHI3_BLIND]
