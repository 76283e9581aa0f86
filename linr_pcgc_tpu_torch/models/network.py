"""Model configuration and parameters of the LINR-PCGC occupancy network.

Port of the serving half of linr_pcgc_tpu/models/network.py.  Parameters
are a flat dict of float32 tensors whose keys (``"block_in.irn.c00.w"``)
and insertion order follow the JAX ``flatten_params`` order exactly: sorted
dict keys at every level, list entries in order.  That order is part of
the weight-bitstream format, so a flat vector (or a JAX ``model.npz``)
moves between the packages unchanged (``params_from_flat``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

STAGE_GROUPS = {
    8: tuple((o,) for o in range(8)),
    4: ((0, 1), (2, 3), (4, 5), (6, 7)),
    3: ((0, 1), (6, 7), (2, 3, 4, 5)),
    2: ((0, 1, 6, 7), (2, 3, 4, 5)),
    1: (tuple(range(8)),),
}

DILATION_LIST = (1, 2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyper-parameters; defaults match the reference CLI defaults."""

    scale_num: int = 7
    in_channel: int = 7
    hidden_channel_conv: int = 8
    hidden_channel_mlp: int = 24
    embed_dim: int = 8
    scale_mlp_hidden: int = 16
    block_layers: int = 1
    outstage: int = 8
    instage: int = 1
    kernel_size: int = 3
    block_type: str = "inception"

    def __post_init__(self):
        if self.block_layers < 1:
            raise ValueError(f"block_layers must be >= 1, got {self.block_layers}")
        if self.outstage not in STAGE_GROUPS:
            raise ValueError(f"outstage={self.outstage}: supported {sorted(STAGE_GROUPS)}")
        if self.instage != 1:
            raise NotImplementedError(f"instage={self.instage}: only instage=1 is implemented")
        if self.block_type not in ("inception", "resnet", "dilation"):
            raise ValueError(f"unknown block_type {self.block_type!r}")

    @property
    def ch(self) -> int:
        return self.hidden_channel_conv

    @property
    def kvol(self) -> int:
        return self.kernel_size**3

    @property
    def groups(self) -> tuple:
        return STAGE_GROUPS[self.outstage]

    @property
    def group_perm(self) -> tuple:
        """Octant order as the context channels see it (groups concatenated)."""
        return tuple(o for g in self.groups for o in g)

    @property
    def cum_group(self) -> tuple:
        out, c = [], 0
        for g in self.groups:
            c += len(g)
            out.append(c)
        return tuple(out)

    @property
    def ctx_channels(self) -> int:
        return 8 - len(self.groups[-1])

    @property
    def gmax(self) -> int:
        return max(len(g) for g in self.groups)


# ------------------------------------------------------------ param tree --


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    init: str            # "uniform" | "zeros" | "normal"
    bound: float = 0.0


def _linear(din, dout, lead=()):
    """nn.Linear with xavier_uniform(gain=relu) weights and zero bias."""
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (din + dout))
    return {"w": _Leaf(lead + (din, dout), "uniform", bound),
            "b": _Leaf(lead + (dout,), "zeros")}


def _conv(kvol, cin, cout, lead=()):
    """MinkowskiConvolution default init: U(-s, s), s = 1/sqrt(cin*kvol)."""
    s = 1.0 / math.sqrt(cin * kvol)
    shape = (kvol, cin, cout) if kvol > 1 else (cin, cout)
    return {"w": _Leaf(lead + shape, "uniform", s),
            "b": _Leaf(lead + (cout,), "uniform", s)}


def _irn(ch, kvol):
    h = ch // 2
    return {"c00": _conv(kvol, ch, h), "c01": _conv(kvol, h, h),
            "c10": _conv(1, ch, h), "c11": _conv(kvol, h, h),
            "c12": _conv(1, h, h)}


def _resnet(ch, kvol):
    return {"r0": _conv(kvol, ch, ch), "r1": _conv(kvol, ch, ch)}


def _dilated(ch, kvol):
    nd = len(DILATION_LIST)
    return {"dc0": [_conv(kvol, ch, ch) for _ in range(nd)],
            "dl0": _conv(1, ch * nd, ch),
            "dc1": [_conv(kvol, ch, ch) for _ in range(nd)],
            "dl1": _conv(1, ch * nd, ch)}


def _block(cin, ch, cout, kvol, layers=1, block_type="inception"):
    if layers == 1 and block_type == "inception":
        core = {"irn": _irn(ch, kvol)}
    else:
        fn = {"inception": _irn, "resnet": _resnet, "dilation": _dilated}[block_type]
        core = {"core": [fn(ch, kvol) for _ in range(layers)]}
    return {"conv_in": _conv(kvol, cin, ch), **core, "conv_out": _conv(kvol, ch, cout)}


def _param_tree(cfg: ModelConfig):
    S, ch, emb = cfg.scale_num, cfg.ch, cfg.embed_dim
    if cfg.gmax == 1:
        l1 = _linear(cfg.hidden_channel_mlp, 1, (cfg.outstage,))
    else:
        l1 = [_linear(cfg.hidden_channel_mlp, len(g)) for g in cfg.groups]
    return {
        "scale_emb": _Leaf((S, emb), "normal"),
        "scale_mlp": {
            "l0": _linear(emb + cfg.in_channel, cfg.scale_mlp_hidden, (S,)),
            "l1": _linear(cfg.scale_mlp_hidden, ch, (S,)),
        },
        "block_in": _block(ch, ch, ch, cfg.kvol, cfg.block_layers, cfg.block_type),
        "prune": _conv(cfg.kvol, ch, ch, (cfg.outstage,)),
        "inner_mlp": {"l0": _linear(ch, cfg.hidden_channel_mlp, (cfg.outstage,)), "l1": l1},
        "outer": [
            _block(cfg.cum_group[i], ch, ch, cfg.kvol) for i in range(cfg.outstage - 1)
        ],
    }


def _walk(tree, prefix=""):
    """(key, leaf) pairs in the JAX tree-flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def param_spec(cfg: ModelConfig) -> list:
    """[(key, shape)] in the flatten order — the weight-bitstream layout."""
    return [(k, leaf.shape) for k, leaf in _walk(_param_tree(cfg))]


def init_params(seed: int, cfg: ModelConfig, device="cpu") -> dict:
    """Torch-style random init from a seed (xavier linears, Minkowski-style
    convs, normal scale embedding), drawn leaf by leaf in flatten order."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for key, leaf in _walk(_param_tree(cfg)):
        if leaf.init == "zeros":
            t = torch.zeros(leaf.shape)
        elif leaf.init == "normal":
            t = torch.randn(leaf.shape, generator=gen)
        else:
            t = torch.empty(leaf.shape).uniform_(-leaf.bound, leaf.bound, generator=gen)
        out[key] = t.to(device)
    return out


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())


def flatten_params(params: dict) -> torch.Tensor:
    """1-D view of all parameters in the flatten order."""
    return torch.cat([p.reshape(-1) for p in params.values()])


def unflatten_params(cfg: ModelConfig, flat, device="cpu") -> dict:
    if not torch.is_tensor(flat):
        flat = torch.from_numpy(np.array(flat, np.float32))
    out, pos = {}, 0
    for key, shape in param_spec(cfg):
        n = int(np.prod(shape))
        out[key] = flat[pos: pos + n].reshape(shape).float().to(device)
        pos += n
    if pos != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} values, the model {pos}")
    return out


def params_from_flat(flat: np.ndarray, cfg: ModelConfig, device="cpu") -> dict:
    """JAX ``flatten_params`` vector -> the port's parameter dict."""
    return unflatten_params(cfg, np.asarray(flat, np.float32), device)


def params_to_flat(params: dict) -> np.ndarray:
    """Inverse of :func:`params_from_flat`."""
    return flatten_params(params).detach().float().cpu().numpy()


def param_tree(params: dict):
    """Nested view (dicts; lists for numbered entries) of a flat dict."""
    root: dict = {}
    for key, t in params.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def listify(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [listify(n[str(i)]) for i in range(len(n))]
        return {k: listify(v) for k, v in n.items()}

    return listify(root)


def stack_outer_blocks(tree: dict, cfg: ModelConfig) -> dict:
    """Stack the ragged per-stage context blocks into dense tensors, the
    conv_in input channels zero-padded to ``ctx_channels`` (exact: zero
    weights contribute 0.0), so a stage index selects a block by row."""
    k = cfg.ctx_channels
    outer = tree["outer"]
    conv_in_w = torch.stack([
        torch.nn.functional.pad(p["conv_in"]["w"], (0, 0, 0, k - cfg.cum_group[i]))
        for i, p in enumerate(outer)
    ])

    def stack(fn):
        first = fn(outer[0])
        return {
            name: {leaf: torch.stack([fn(p)[name][leaf] for p in outer]) for leaf in first[name]}
            for name in first
        }

    return {
        "conv_in_w": conv_in_w,
        "conv_in_b": torch.stack([p["conv_in"]["b"] for p in outer]),
        "irn": stack(lambda p: p["irn"]),
        "conv_out": {leaf: torch.stack([p["conv_out"][leaf] for p in outer])
                     for leaf in ("b", "w")},
    }
