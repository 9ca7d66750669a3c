"""The port's public flags against the JAX package's: which checkpoint
``load`` / ``generate`` pick from the same flags, the ``verbose`` prompt
banner, and the server's command line.

``_load`` is stubbed on both sides to return its ``model_path``, and
``generate_text`` to return nothing, so no model is built: only the
selection and the printed text are compared.
"""

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
