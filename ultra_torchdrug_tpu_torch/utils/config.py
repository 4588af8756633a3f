"""Config system (counterpart of ultra_torchdrug_tpu/utils/config.py):
Jinja2-templated YAML with auto-discovered CLI flags, hyperparameter grids,
and the string registry that ``class`` keys resolve through.

  * undeclared template variables become required --flags
  * a ``---`` separator splits a YAML grid front-matter that is mesh-expanded
    into one config per combination
  * "class"-keyed sections instantiate through ``register``/``lookup``

yaml and jinja2 are imported inside the functions that read a file, so the
registry (and with it the package) imports where they are not installed.
"""

from __future__ import annotations

import argparse
import ast
from typing import Any, Dict, Iterator, List


def meshgrid(d: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    if not d:
        yield {}
        return
    key = next(iter(d))
    values = d[key]
    rest = {k: v for k, v in d.items() if k != key}
    if not isinstance(values, list):
        values = [values]
    for v in values:
        for r in meshgrid(rest):
            yield {**r, key: v}


def literal_eval(value: str):
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def detect_variables(cfg_file: str):
    import jinja2
    from jinja2 import meta

    with open(cfg_file) as f:
        raw = f.read()
    env = jinja2.Environment()
    return sorted(meta.find_undeclared_variables(env.parse(raw)))


def load_config(cfg_file: str, context: Dict[str, Any] | None = None) -> List[dict]:
    import jinja2
    import yaml

    with open(cfg_file) as f:
        raw = f.read()
    if "---" in raw:
        grid_text, template_text = raw.split("---", 1)
        grid = yaml.safe_load(grid_text) or {}
        template = jinja2.Template(template_text)
        configs = []
        for hyper in meshgrid(grid):
            if context:
                hyper = {**hyper, **context}
            configs.append(yaml.safe_load(template.render(hyper)))
        return configs
    if context:
        raw = jinja2.Template(raw).render(context)
    return [yaml.safe_load(raw)]


def parse_args(argv=None):
    """-c/--config + --seed, plus a required flag for every undeclared
    template variable in the config."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-s", "--seed", type=int, default=1024)
    args, unparsed = parser.parse_known_args(argv)
    tvars = detect_variables(args.config)
    var_parser = argparse.ArgumentParser()
    for var in tvars:
        # required: a missing flag would render as an empty string and break
        # the config far downstream
        var_parser.add_argument(f"--{var}", required=True)
    picked = var_parser.parse_known_args(unparsed)[0]
    context = {
        k: literal_eval(v) for k, v in vars(picked).items() if v is not None
    }
    return args, context


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Any] = {}


def register(name: str):
    def deco(obj):
        _REGISTRY[name] = obj
        return obj

    return deco


def lookup(name: str):
    if name not in _REGISTRY:
        raise KeyError(
            f"{name!r} is not registered; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def registered_names():
    return sorted(_REGISTRY)
