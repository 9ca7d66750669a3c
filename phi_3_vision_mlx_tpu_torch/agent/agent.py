"""Agent: a toolchain of string-DSL steps (counterpart of
``phi_3_vision_mlx_tpu/agent/agent.py``; the reference's ``Agent``).

A toolchain is a multi-line string of ``out1, out2 = tool(arg1, arg2)``
steps run over a shared ``ongoing`` dict; each tool gets the agent's keyword
arguments that its signature names, each call is logged to
``agent_log.json``, and with the API tools enabled a prompt's double quotes
become ``<|api_input|>``.  Tool names resolve through a registry (the
port's ``api`` and ``agent/tools``, plus any callables passed as
``tools=``), never through ``eval``.
"""

from __future__ import annotations

import inspect
import json
from typing import Callable, Dict, Optional


def _default_registry() -> Dict[str, Callable]:
    from .. import api
    from . import tools

    return {
        "add_code": tools.add_code,
        "add_text": tools.add_text,
        "rag": tools.rag,
        "get_api": tools.get_api,
        "generate": api.generate,
        "choose": api.choose,
        "constrain": api.constrain,
        "execute": api.execute,
    }


class Agent:
    """Toolchain executor (see the module docstring).  Without
    ``preload=(lm, processor)`` it loads a model as ``api.load`` does, from
    the flags given (``blind_model``, ``quantize_model``, ``quantize_cache``,
    ``use_adapter``, ``device``).

    Example::

        agent = Agent(preload=(lm, processor))
        result = agent("Plot a sine wave.")
        result["responses"], result["files"]
    """

    _default_toolchain = """
        prompt = add_code(prompt, codes)
        responses = generate(prompt, images)
        files, codes = execute(responses, step)
        """

    def __init__(self, toolchain: Optional[str] = None, enable_api: bool = True,
                 tools: Optional[Dict[str, Callable]] = None, **kwargs):
        from ..api import load

        self.registry = _default_registry()
        if tools:
            self.registry.update(tools)
        kwargs = kwargs | {"enable_api": enable_api}
        self.enable_api = enable_api
        self.kwargs = kwargs if "preload" in kwargs else kwargs | {"preload": load(**{
            k: v for k, v in kwargs.items()
            if k in ("blind_model", "quantize_model", "quantize_cache", "use_adapter", "device")
        })}
        self.set_toolchain(toolchain)
        self.reset()

    def __call__(self, prompt: str, images=None):
        prompt = prompt.replace('"', "<|api_input|>") if self.enable_api else prompt
        self.ongoing.update({"prompt": prompt})
        if images is not None:
            self.ongoing.update({"images": images})
        for tool in self.toolchain:
            fxn = tool["fxn"]
            args = [self.ongoing.get(i, None) for i in tool["args"]]
            params = inspect.signature(fxn).parameters.keys()
            returned = fxn(*args, **{k: v for k, v in self.kwargs.items() if k in params})
            if isinstance(returned, dict):
                self.ongoing.update({k: returned[k] for k in tool["out"]})
            else:
                self.ongoing.update({k: returned for k in tool["out"]})
        self.log_step()
        return {i: self.ongoing.get(i, None) for i in self.list_outs}

    def reset(self):
        self.log = []
        self.ongoing = {"step": 0}

    def log_step(self):
        self.log.append({k: _jsonable(v) for k, v in self.ongoing.items()})
        with open("agent_log.json", "w") as f:
            json.dump(self.log, f, indent=4)
        self.ongoing = {k: None if v == [None] else v for k, v in self.ongoing.items()}
        self.ongoing["step"] += 1

    def end(self):
        self.ongoing.update({"END": "END"})
        self.log_step()
        self.reset()

    def set_toolchain(self, s: Optional[str]):
        def _parse_step(line: str):
            line = line.strip().rstrip(")")
            out_part, fxn_part = line.split("=")
            fxn_name, args_part = fxn_part.split("(")
            name = fxn_name.strip()
            if name not in self.registry:
                raise KeyError(f"unknown tool {name!r}; register it via Agent(tools={{...}})")
            return {
                "fxn": self.registry[name],
                "args": [a.strip() for a in args_part.split(",")],
                "out": [o.strip() for o in out_part.split(",")],
            }

        def _parse_return(s: str):
            if "return " not in s:
                return ["responses", "files"]
            return [i.strip() for i in s.split("return ")[1].split(",")]

        s = self._default_toolchain if s is None else s
        self.toolchain = [_parse_step(i) for i in s.split("\n") if "=" in i]
        self.list_outs = _parse_return(s)


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)
