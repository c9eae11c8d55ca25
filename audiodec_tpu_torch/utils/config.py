"""Experiment configs (counterpart of audiodec_tpu/utils/config.py:
`_deep_merge`, `load_config` with `inherit:`, `load_config_near_checkpoint`,
`generator_config` and the discriminator configs), and `dump_yaml`, which
writes a config that `yaml.safe_load` and `parse_yaml` both read back as
the same dict (PyYAML's `safe_dump` stands in the JAX package).

The machine with the card has no PyYAML, so `parse_yaml` reads the subset
of YAML that the repo's configs use, with PyYAML's (YAML 1.1) reading of
plain scalars so that it gives `yaml.safe_load`'s dict:

  - block maps and block lists (a list may sit at its key's indentation,
    and an item may open a nested list or map: `- - 1`, `- key: v`);
  - flow lists such as `[3, 4, 5, 5]`, nested ones included;
  - the empty flow map `{}`;
  - null (`null`, `~`, empty), booleans (`true`, `yes`, `off`, ...),
    decimal ints, floats with a dot (`2.0e-4`; YAML 1.1 reads `1e-12`, with
    no dot, as a string), `.inf` and `.nan`;
  - plain, single- and double-quoted strings, and comments.

Anything else (other flow maps, anchors and aliases, tags, block scalars,
multi-line plain scalars, several documents, octal, hex and sexagesimal
numbers, dates) raises ValueError rather than be read differently.
"""

from __future__ import annotations

import os
import re

from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.models import discriminators as disc
from audiodec_tpu_torch.models import vocoder as voc

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# YAML 1.1 forms PyYAML reads as numbers or dates that this reader does not
_UNSUPPORTED = re.compile(
    r"[-+]?0b[01_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")
_DQ_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}


def _plain(text: str, where: str):
    """A plain scalar as PyYAML's resolver reads it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    if (_UNSUPPORTED.match(text) or text[0] in "&*!|>%@`{}#"
            or ": " in text or text.endswith(":") or " #" in text):
        raise ValueError(f"{where}: unsupported YAML scalar {text!r}")
    return text


def _quoted(text: str, where: str) -> str:
    q, body = text[0], text[1:-1]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"{where}: unterminated string {text!r}")
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise ValueError(f"{where}: bad single-quoted string {text!r}")
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == '"':
            raise ValueError(f"{where}: bad double-quoted string {text!r}")
        if ch == "\\":
            esc = body[i + 1:i + 2]
            if esc not in _DQ_ESCAPES:
                raise ValueError(f"{where}: unsupported escape \\{esc}")
            out.append(_DQ_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _scalar(text: str, where: str):
    text = text.strip()
    if text == "{}":
        return {}
    if text[:1] in ("'", '"'):
        return _quoted(text, where)
    if text[:1] == "[":
        value, rest = _flow_list(text, 0, where)
        if text[rest:].strip():
            raise ValueError(f"{where}: text after a flow list: {text!r}")
        return value
    return _plain(text, where)


def _flow_list(text: str, i: int, where: str):
    """Parse `[...]` starting at text[i] == '['; -> (list, index after)."""
    out = []
    expect_item = False
    i += 1
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise ValueError(f"{where}: unterminated flow list")
        if text[i] == "]":
            if out and expect_item:
                raise ValueError(f"{where}: empty flow list item")
            return out, i + 1
        if text[i] == "[":
            item, i = _flow_list(text, i, where)
        elif text[i] in ("'", '"'):
            end = text.find(text[i], i + 1)
            # '' inside a single-quoted string is an escaped quote
            while (text[i] == "'" and end != -1
                   and text[end + 1:end + 2] == "'"):
                end = text.find("'", end + 2)
            if end == -1:
                raise ValueError(f"{where}: unterminated string")
            item, i = _quoted(text[i:end + 1], where), end + 1
        else:
            m = re.compile(r"[^,\[\]{}]*").match(text, i)
            raw = m.group().strip()
            if not raw:
                raise ValueError(f"{where}: empty flow list item")
            item, i = _plain(raw, where), m.end()
        out.append(item)
        while i < len(text) and text[i] == " ":
            i += 1
        expect_item = False
        if i < len(text) and text[i] == ",":
            i += 1
            expect_item = True
        elif i < len(text) and text[i] != "]":
            raise ValueError(f"{where}: bad flow list {text!r}")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " [,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """'key: value' / 'key:' -> (key, value text) or None if not a pair."""
    m = re.match(r"""('(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^'"][^#]*?)"""
                 r"""\s*:(?:\s+|$)""", text)
    if not m or text[:1] in ("[", "{") or text.startswith("- "):
        return None
    return m.group(1), text[m.end():]


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines = []  # [indent, content, line number]
        for no, raw in enumerate(text.splitlines(), 1):
            if raw.startswith("%") or raw.strip() in ("---", "..."):
                raise ValueError(f"{name}:{no}: YAML directives and "
                                 f"documents are not supported")
            line = _strip_comment(raw)
            content = line.lstrip(" ")
            if not content:
                continue
            if "\t" in line[:len(line) - len(content) + 1]:
                raise ValueError(f"{name}:{no}: tab indentation")
            self.lines.append([len(line) - len(content), content, no])

    def where(self, i: int) -> str:
        return f"{self.name}:{self.lines[i][2]}"

    def block(self, i: int, indent: int):
        content = self.lines[i][1]
        if content == "-" or content.startswith("- "):
            return self.seq(i, indent)
        if _split_key(content) is None:
            raise ValueError(f"{self.where(i)}: expected a key or a list "
                             f"item, got {content!r}")
        return self.map(i, indent)

    def nested(self, i: int, indent: int, allow_same_level_list: bool):
        """The block value of a key or item whose own line ended at i - 1."""
        n = len(self.lines)
        if i < n and self.lines[i][0] > indent:
            return self.block(i, self.lines[i][0])
        if (allow_same_level_list and i < n and self.lines[i][0] == indent
                and (self.lines[i][1] == "-"
                     or self.lines[i][1].startswith("- "))):
            return self.seq(i, indent)
        return None, i

    def map(self, i: int, indent: int):
        out = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            content = self.lines[i][1]
            pair = _split_key(content)
            if pair is None:
                break
            key = _scalar(pair[0], self.where(i))
            if pair[1].strip():
                out[key] = _scalar(pair[1], self.where(i))
                i += 1
            else:
                out[key], i = self.nested(i + 1, indent, True)
        return out, i

    def seq(self, i: int, indent: int):
        out = []
        while (i < len(self.lines) and self.lines[i][0] == indent
               and (self.lines[i][1] == "-"
                    or self.lines[i][1].startswith("- "))):
            rest = self.lines[i][1][1:]
            text = rest.lstrip(" ")
            if not text:
                item, i = self.nested(i + 1, indent, False)
            elif text == "-" or text.startswith("- ") or _split_key(text):
                # the item opens a nested block on the dash's line
                self.lines[i][0] = indent + 1 + len(rest) - len(text)
                self.lines[i][1] = text
                item, i = self.block(i, self.lines[i][0])
            else:
                item, i = _scalar(text, self.where(i)), i + 1
            out.append(item)
        return out, i

    def document(self):
        if not self.lines:
            return None
        if self.lines[0][0] != 0 and len(self.lines) > 1:
            raise ValueError(f"{self.where(0)}: indented document")
        if len(self.lines) == 1 and not (
                _split_key(self.lines[0][1])
                or self.lines[0][1].startswith("-")):
            return _scalar(self.lines[0][1], self.where(0))
        value, i = self.block(0, self.lines[0][0])
        if i != len(self.lines):
            raise ValueError(f"{self.where(i)}: unexpected indentation or "
                             f"construct: {self.lines[i][1]!r}")
        return value


def parse_yaml(text: str, name: str = "<yaml>"):
    """The repo's YAML subset -> Python values, as yaml.safe_load reads it."""
    return _Reader(text, name).document()


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> dict:
    """Load a YAML config; an `inherit: <relative path>` key deep-merges
    the file over its base."""
    with open(path) as f:
        cfg = parse_yaml(f.read(), path)
    if isinstance(cfg, dict) and "inherit" in cfg:
        base = load_config(os.path.join(os.path.dirname(path),
                                        cfg.pop("inherit")))
        cfg = _deep_merge(base, cfg)
    return cfg


def load_config_near_checkpoint(ckpt_path: str) -> dict:
    """The config.yml beside a checkpoint."""
    return load_config(os.path.join(os.path.dirname(ckpt_path), "config.yml"))


def generator_config(config: dict):
    """model_type -> the generator's config: GeneratorConfig for symAD,
    VocoderConfig for a HiFiGAN vocoder."""
    model_type = config.get("model_type", "symAudioDec")
    gp = config.get("generator_params", {})
    if model_type in ("symAudioDec", "symAudioDecUniv"):
        return ae.config_from_yaml(gp)
    if model_type in ("HiFiGAN", "UnivNet"):
        return voc.config_from_yaml(gp, stats=gp.get("stats") is not None)
    raise NotImplementedError(f"Model type {model_type} is not supported!")


def _act_params(d: dict) -> tuple:
    return tuple(sorted(d.get("nonlinear_activation_params", {}).items()))


def _period_config(p: dict) -> disc.PeriodDiscriminatorConfig:
    return disc.PeriodDiscriminatorConfig(
        in_channels=p.get("in_channels", 1),
        out_channels=p.get("out_channels", 1),
        kernel_sizes=tuple(p.get("kernel_sizes", (5, 3))),
        channels=p.get("channels", 32),
        downsample_scales=tuple(p.get("downsample_scales", (3, 3, 3, 3, 1))),
        max_downsample_channels=p.get("max_downsample_channels", 1024),
        bias=p.get("bias", True),
        nonlinear_activation=p.get("nonlinear_activation", "LeakyReLU"),
        nonlinear_activation_params=_act_params(p),
        use_spectral_norm=p.get("use_spectral_norm", False))


def _mpd_config(d: dict) -> disc.MultiPeriodConfig:
    return disc.MultiPeriodConfig(
        periods=tuple(d.get("periods", (2, 3, 5, 7, 11))),
        discriminator=_period_config(d.get("period_discriminator_params",
                                           {})))


def hifigan_discriminator_config(d: dict):
    """A config's discriminator_params block -> HiFiGAN MSD + MPD."""
    pool = d.get("scale_downsample_pooling_params", {})
    p = d.get("scale_discriminator_params", {})
    scale = disc.ScaleDiscriminatorConfig(
        in_channels=p.get("in_channels", 1),
        out_channels=p.get("out_channels", 1),
        kernel_sizes=tuple(p.get("kernel_sizes", (15, 41, 5, 3))),
        channels=p.get("channels", 128),
        max_downsample_channels=p.get("max_downsample_channels", 1024),
        max_groups=p.get("max_groups", 16),
        bias=p.get("bias", True),
        downsample_scales=tuple(p.get("downsample_scales", (2, 2, 4, 4, 1))),
        nonlinear_activation=p.get("nonlinear_activation", "LeakyReLU"),
        nonlinear_activation_params=_act_params(p))
    return disc.HiFiGANDiscriminatorConfig(
        msd=disc.MultiScaleConfig(
            scales=d.get("scales", 3),
            follow_official_norm=d.get("follow_official_norm", True),
            pool_kernel=pool.get("kernel_size", 4),
            pool_stride=pool.get("stride", 2),
            pool_padding=pool.get("padding", 2),
            discriminator=scale),
        mpd=_mpd_config(d))


def univnet_discriminator_config(d: dict):
    """A config's discriminator_params block -> UnivNet MRSD + MPD."""
    sp = d.get("spectral_discriminator_params", {})
    default = disc.SpectralDiscriminatorConfig()
    return disc.UnivNetDiscriminatorConfig(
        mrsd=disc.MultiResolutionSpectralConfig(
            fft_sizes=tuple(d.get("fft_sizes", (1024, 2048, 512))),
            hop_sizes=tuple(d.get("hop_sizes", (120, 240, 50))),
            win_lengths=tuple(d.get("win_lengths", (600, 1200, 240))),
            discriminator=disc.SpectralDiscriminatorConfig(
                kernel_sizes=tuple(tuple(k) for k in sp.get(
                    "kernel_sizes", default.kernel_sizes)),
                strides=tuple(tuple(s) for s in sp.get(
                    "strides", default.strides)),
                channels=sp.get("channels", 32),
                bias=sp.get("bias", True),
                nonlinear_activation=sp.get("nonlinear_activation",
                                            "LeakyReLU"),
                nonlinear_activation_params=(
                    _act_params(sp) or (("negative_slope", 0.2),)))),
        mpd=_mpd_config(d),
        flat_channel=d.get("flat_channel", False))


def discriminator_config(config: dict):
    """model_type -> the discriminator's config."""
    model_type = config.get("model_type", "symAudioDec")
    dp = config.get("discriminator_params", {})
    if model_type in ("symAudioDec", "HiFiGAN"):
        return hifigan_discriminator_config(dp)
    if model_type in ("symAudioDecUniv", "UnivNet"):
        return univnet_discriminator_config(dp)
    raise NotImplementedError(f"Model type {model_type} is not supported!")


# ---------------------------------------------------------------------------
# writing YAML
# ---------------------------------------------------------------------------

_PLAIN_STR = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*$")


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        # YAML 1.1 reads a float only with a dot: 1e-05 -> 1.0e-05
        if "." not in text:
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        if "e" in text and text.split("e")[1][0] not in "+-":
            text = text.replace("e", "e+")
        return text
    if isinstance(v, str):
        if _PLAIN_STR.match(v) and _plain(v, "") == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _dump_flow(v) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    return _dump_scalar(v)


def _is_flat(v) -> bool:
    """A list written as one flow list: scalars and such lists only."""
    return all(_is_flat(x) if isinstance(x, (list, tuple))
               else not isinstance(x, dict) for x in v)


def _dump_block(v, indent: int, out: list):
    pad = " " * indent
    if isinstance(v, dict):
        for k, item in v.items():
            key = _dump_scalar(k)
            if isinstance(item, dict) and item:
                out.append(f"{pad}{key}:")
                _dump_block(item, indent + 4, out)
            elif isinstance(item, (list, tuple)) and not _is_flat(item):
                out.append(f"{pad}{key}:")
                _dump_block(item, indent + 4, out)
            else:
                out.append(f"{pad}{key}: " + ("{}" if isinstance(item, dict)
                                              else _dump_flow(item)))
        return
    for item in v:
        if isinstance(item, dict) and item:
            lines: list = []
            _dump_block(item, indent + 2, lines)
            out.append(f"{pad}- " + lines[0][indent + 2:])
            out.extend(lines[1:])
        elif isinstance(item, (list, tuple)) and not _is_flat(item):
            out.append(f"{pad}-")
            _dump_block(item, indent + 2, out)
        else:
            out.append(f"{pad}- " + ("{}" if isinstance(item, dict)
                                     else _dump_flow(item)))


def dump_yaml(config: dict) -> str:
    """A config dict (dicts, lists, strings, numbers, booleans, None) as
    block YAML that yaml.safe_load and parse_yaml read back as `config`."""
    if not isinstance(config, dict):
        raise TypeError("dump_yaml writes a dict")
    if not config:
        return "{}\n"
    out: list = []
    _dump_block(config, 0, out)
    return "\n".join(out) + "\n"
