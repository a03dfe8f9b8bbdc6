"""Versioned symbol-JSON upgrade (reference `src/nnvm/legacy_json_util.cc`).

PyTorch-port copy of `incubator_mxnet_tpu/compat/legacy_json.py`; the
port reads the same graphs and keeps its own copy of the passes.

Old MXNet releases serialized graphs the loader of a newer release must
still accept.  The reference runs an ordered upgrader list over the parsed
graph (`legacy_json_util.cc:187-219`); the same passes are re-expressed
here as dict-level rewrites applied before `symbol.load_json` builds nodes:

* < 0.9.0   — aux-state variables (BatchNorm moving mean/var, ...) were not
  serialized: append `{node}_{arg}` variable nodes for the missing trailing
  inputs (`UpgradeJSON_000800_000900`, legacy_json_util.cc:135).
* < 0.9.4   — optimizer hints (lr_mult/wd_mult/...) were stored as plain
  attrs, possibly `arg_mult`-suffixed onto the op node: move them to
  `__key__` form, suffixed ones onto the referenced input variable
  (`UpgradeJSON_FixParsing`, :49, kHiddenKeys from c_api_symbolic.cc:40).
* < 0.9.5   — argmin/argmax serialized `axis="-1"` to mean "flatten all":
  drop the attr so the modern default applies (`UpgradeJSON_000904_000905`,
  :175).

Unknown attrs that newer parsers reject are otherwise preserved verbatim —
`Symbol.load_json` decides what to do with them.
"""
from __future__ import annotations

import json

CURRENT_VERSION = 10200

# c_api_symbolic.cc:40 kHiddenKeys
HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
               "mirror_stage")


def _node_attrs(jn):
    # the attr dict itself moved names over time: param -> attr -> attrs
    for key in ("attrs", "attr", "param"):
        if key in jn:
            return jn[key], key
    jn["attrs"] = {}
    return jn["attrs"], "attrs"


def _expected_inputs(op_name, attrs):
    from ..ops import registry as _reg
    op = _reg.maybe_get(op_name)
    if op is None:
        return None
    try:
        params = op.canonicalize_params(dict(attrs))
    except Exception:
        params = {k: v for k, v in op.params.items()
                  if v is not _reg.REQUIRED}
    names = op.list_input_names(params)
    if names is not None:
        return names
    return [f"arg{i}" for i in range(op.nin)] if op.nin >= 0 else None


def _upgrade_add_aux_vars(g):
    """< 0.9.0: re-create unserialized trailing variable inputs.

    New variables are inserted immediately before their consuming op so the
    node list stays topologically ordered (loaders build sequentially);
    every index in inputs/arg_nodes/heads is remapped.
    """
    old_nodes = g["nodes"]
    new_nodes = []
    remap = {}
    new_args = []
    for idx, jn in enumerate(old_nodes):
        jn = dict(jn)
        jn["inputs"] = [[remap[e[0]], *e[1:]] for e in jn["inputs"]]
        if jn["op"] != "null":
            attrs, _ = _node_attrs(jn)
            names = _expected_inputs(jn["op"], attrs)
            if names is not None:
                for i in range(len(jn["inputs"]), len(names)):
                    var_name = (f"{jn['name']}_{names[i]}" if jn["name"]
                                else names[i])
                    new_nodes.append({"op": "null", "name": var_name,
                                      "attrs": {}, "inputs": []})
                    new_args.append(len(new_nodes) - 1)
                    jn["inputs"].append([len(new_nodes) - 1, 0, 0])
        remap[idx] = len(new_nodes)
        new_nodes.append(jn)
    g["nodes"] = new_nodes
    g["arg_nodes"] = sorted([remap[i] for i in g.get("arg_nodes", [])]
                            + new_args)
    if "heads" in g:
        g["heads"] = [[remap[e[0]], *e[1:]] for e in g["heads"]]
    g.pop("node_row_ptr", None)
    return g


def _upgrade_hidden_keys(g):
    """< 0.9.4: plain lr_mult/wd_mult/... attrs -> __key__ form."""
    nodes = g["nodes"]
    for jn in nodes:
        attrs, akey = _node_attrs(jn)
        moved = {}
        for k in list(attrs):
            for hk in HIDDEN_KEYS:
                if k == hk:
                    moved[f"__{hk}__"] = attrs.pop(k)
                    break
                if k.endswith("_" + hk):
                    # `{arg}_lr_mult` on the op node belongs on the {arg}
                    # input variable
                    arg = k[: -len(hk) - 1]
                    names = _expected_inputs(jn["op"], attrs) or []
                    if arg in names:
                        i = names.index(arg)
                        if i < len(jn["inputs"]):
                            tgt = nodes[jn["inputs"][i][0]]
                            if tgt["op"] == "null":
                                tattrs, _ = _node_attrs(tgt)
                                tattrs[f"__{hk}__"] = attrs.pop(k)
                                break
                    moved[f"__{hk}__"] = attrs.pop(k)
                    break
        attrs.update(moved)
        if akey != "attrs":
            jn["attrs"] = jn.pop(akey)
    return g


def _upgrade_argmax_axis(g):
    """< 0.9.5: argmin/argmax axis="-1" meant the modern default."""
    for jn in g["nodes"]:
        if jn["op"] in ("argmin", "argmax"):
            attrs, _ = _node_attrs(jn)
            if attrs.get("axis") == "-1":
                del attrs["axis"]
    return g


_UPGRADERS = [
    (10000, _upgrade_hidden_keys),
    (900, _upgrade_add_aux_vars),
    (905, _upgrade_argmax_axis),
]


def upgrade_json(json_str_or_dict):
    """Apply every upgrade pass newer than the graph's recorded version.

    Mirrors `LoadLegacyJSONPass` (`legacy_json_util.cc:195-219`): missing
    version metadata means 0.8.0 (800).
    """
    g = (json.loads(json_str_or_dict) if isinstance(json_str_or_dict, str)
         else json_str_or_dict)
    version = 800
    attrs = g.get("attrs", {})
    if isinstance(attrs, dict) and "mxnet_version" in attrs:
        v = attrs["mxnet_version"]
        version = int(v[1] if isinstance(v, (list, tuple)) else v)
    for threshold, fn in sorted(_UPGRADERS):
        if threshold > version:
            g = fn(g)
    g.setdefault("attrs", {})["mxnet_version"] = ["int", CURRENT_VERSION]
    return g
