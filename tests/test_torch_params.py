"""The port's parameter surface (`beatrice_vst_tpu_torch/params/`) against
the JAX package's: schema entries field by field, `ParameterState` bytes
after the same edits, truncated states, model cards accepted and refused,
the normalised mapping, and the proxy's replay and Lock rules driving each
package's `StreamHandle` over a recording engine.

Gates: exact equality (the modules are copies); morph weights, which the
JAX handle prunes with jnp and the port with torch on the CPU, at atol
1e-7."""

import dataclasses
import io
import types

import numpy as np
import pytest
import torch

from beatrice_vst_tpu import params as J
from beatrice_vst_tpu.errors import BeatriceError as JError
from beatrice_vst_tpu.params import normalize as JN
from beatrice_vst_tpu.params.description_url import extract_safe_urls as j_urls
from beatrice_vst_tpu.runtime.handle import StreamHandle as JHandle
from beatrice_vst_tpu_torch import params as P
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.errors import BeatriceError as PError
from beatrice_vst_tpu_torch.params import normalize as PN
from beatrice_vst_tpu_torch.params.description_url import extract_safe_urls as p_urls
from beatrice_vst_tpu_torch.runtime.handle import StreamHandle as PHandle

torch.set_num_threads(1)

GOOD_TOML = """
[model]
version = "2.0.0-rc.0"
name = "TestModel"
description = "see https://example.com/a_b?x=1 and http://bad$.com"

[voice.0]
name = "A"
description = ""
average_pitch = 60.0
[voice.0.portrait]
path = ""
description = ""

[voice.1]
name = "B"
description = ""
average_pitch = 48.0
[voice.1.portrait]
path = "b.png"
description = "portrait"

[voice.2]
name = "C"
description = ""
average_pitch = 66.5
"""

# name -> card text: accepted, or refused with an ErrorCode (the cases of
# tests/test_params.py:85-117 and more)
CARDS = {
    "good": GOOD_TOML,
    "gap": GOOD_TOML.replace("[voice.1]", "[voice.3]").replace("[voice.1.portrait]",
                                                               "[voice.3.portrait]"),
    "pitch_300": GOOD_TOML.replace("average_pitch = 48.0", "average_pitch = 300.0"),
    "pitch_nan": GOOD_TOML.replace("average_pitch = 48.0", "average_pitch = nan"),
    "nul": GOOD_TOML.replace('name = "A"', 'name = "A\\u0000B"'),
    "syntax": GOOD_TOML.replace("[model]", "[model"),
    "no_version": GOOD_TOML.replace('version = "2.0.0-rc.0"', ""),
    "no_voices": GOOD_TOML[:GOOD_TOML.index("[voice.0]")],
    "id_300": GOOD_TOML.replace("[voice.2]", "[voice.300]"),
    "unknown_version": GOOD_TOML.replace("2.0.0-rc.0", "9.9.9"),
    "name_not_string": GOOD_TOML.replace('name = "A"', "name = 3"),
}

# edits (parameter id, value) fed to both packages' Controllers
EDITS = {
    "voice_lock0": [(J.ParameterID.VOICE, 1), (J.ParameterID.FORMANT_SHIFT, 1.5)],
    "voice_lock1": [(J.ParameterID.LOCK, 1), (J.ParameterID.VOICE, 2),
                    (J.ParameterID.FORMANT_SHIFT, -0.5)],
    "shift_and_source": [(J.ParameterID.PITCH_SHIFT, 5.0),
                         (J.ParameterID.AVERAGE_SOURCE_PITCH, 70.0),
                         (J.ParameterID.INPUT_GAIN, -12.0), (J.ParameterID.VQ_NUM_NEIGHBORS, 4.0)],
    "morph_pad": [(J.ParameterID.VOICE, 3), (J.ParameterID.VOICE_MORPH_CURSOR_X, 0.3),
                  (J.ParameterID.VOICE_MORPH_MARKER_COUNT, 3.0),
                  (int(J.ParameterID.VOICE_MORPH_MARKER_VOICE_BASE) + 2, 2.0)],
}


def _fields(param):
    """A schema entry's data fields by name (callbacks: whether set)."""
    out = {"type": type(param).__name__}
    for f in dataclasses.fields(param):
        v = getattr(param, f.name)
        out[f.name] = (v is not None) if f.name.endswith("_set") else v
    for prop in ("min_value", "max_value", "divisions"):
        if hasattr(param, prop):
            out[prop] = getattr(param, prop)
    return out


def test_schema_entries_equal_field_by_field():
    assert list(P.SCHEMA) == list(J.SCHEMA)
    for pid, jp in J.SCHEMA.items():
        assert _fields(P.SCHEMA[pid]) == _fields(jp), pid
    assert [(m.name, int(m)) for m in P.ParameterID] == [(m.name, int(m)) for m in J.ParameterID]
    assert [(m.name, int(m)) for m in P.ParameterFlag] == [(m.name, int(m))
                                                           for m in J.ParameterFlag]
    for pid in range(-2, 400):
        assert P.is_voice_morph_parameter(pid) == J.is_voice_morph_parameter(pid)


def test_normalized_mapping_equal():
    for pid, jp in J.SCHEMA.items():
        if isinstance(jp, J.StringParameter):
            continue
        for x in (0.0, 0.13, 0.5, 0.77, 1.0, 1.3):
            assert PN.denormalize(P.SCHEMA[pid], x) == JN.denormalize(jp, x)
            assert PN.quantized_normalized(P.SCHEMA[pid], x) == JN.quantized_normalized(jp, x)
        plain = JN.denormalize(jp, 0.4)
        assert PN.normalize(P.SCHEMA[pid], plain) == JN.normalize(jp, plain)


def test_description_urls_equal():
    text = CARDS["good"] + " https://ok.example/p%2F x https://bad.example/%zz ftp://no"
    assert p_urls(text) == j_urls(text)


def _card(tmp_path, name):
    path = tmp_path / f"{name}.toml"
    path.write_text(CARDS[name])
    return str(path)


@pytest.mark.parametrize("edits", sorted(EDITS))
def test_parameter_state_bytes_equal_after_the_same_edits(tmp_path, edits):
    card = _card(tmp_path, "good")
    blobs = []
    for pkg in (J, P):
        c = pkg.Controller()
        assert c.set_parameter(pkg.ParameterID.MODEL, card) == 0
        for pid, value in EDITS[edits]:
            assert c.set_parameter(int(pid), value) == 0
        blobs.append((c.parameter_state.to_bytes(), c.pop_updated_parameters()))
    assert blobs[0][0] == blobs[1][0]
    assert blobs[0][1] == blobs[1][1]
    restored = P.ParameterState.from_bytes(blobs[1][0], P.SCHEMA)
    assert restored.to_bytes() == J.ParameterState.from_bytes(blobs[0][0], J.SCHEMA).to_bytes()


@pytest.mark.parametrize("cut", [1, 3, 5, 7, 9, 13, 20])
def test_truncated_state_raises_the_same_code(cut):
    s = J.ParameterState()
    s.set_value(J.ParameterID.PITCH_SHIFT, 1.5)
    s.set_value(J.ParameterID.VOICE, 3)
    s.set_value(J.ParameterID.MODEL, "/m/config.toml")
    data = s.to_bytes()[:-cut]
    codes = []
    for pkg, err in ((J, JError), (P, PError)):
        try:
            pkg.ParameterState.from_bytes(data)
            codes.append(None)
        except err as e:
            codes.append(int(e.code))
    assert codes[0] == codes[1] and codes[0] is not None


def test_bad_type_index_and_negative_size():
    for blob in (b"\x01\x00\x07\x00\x00\x00", b"\x01\x00\x02\x00\x00\x00\xff\xff\xff\xff"):
        codes = []
        for pkg, err in ((J, JError), (P, PError)):
            with pytest.raises(err) as e:
                pkg.ParameterState.from_bytes(blob)
            codes.append(int(e.value.code))
        assert codes[0] == codes[1]


@pytest.mark.parametrize("card", sorted(CARDS))
def test_model_cards_accepted_and_refused_alike(card):
    got = []
    for pkg, err in ((J, JError), (P, PError)):
        try:
            cfg = pkg.parse_model_config(CARDS[card], path="/m")
            got.append(("ok", cfg.version, cfg.name, cfg.description, cfg.version_int,
                        [(v.name, v.description, v.average_pitch, v.portrait.path,
                          v.portrait.description) for v in cfg.voices]))
        except err as e:
            got.append(("refused", int(e.code)))
    assert got[0] == got[1]


def test_model_card_write_and_load_alike(tmp_path):
    cfg = P.parse_model_config(CARDS["good"])
    P.write_model_config(cfg, str(tmp_path / "p.toml"))
    J.write_model_config(J.parse_model_config(CARDS["good"]), str(tmp_path / "j.toml"))
    assert (tmp_path / "p.toml").read_bytes() == (tmp_path / "j.toml").read_bytes()
    a = P.load_model_config(str(tmp_path / "p.toml"))
    b = J.load_model_config(str(tmp_path / "j.toml"))
    assert ([dataclasses.astuple(v) for v in a.voices], a.path) == (
        [dataclasses.astuple(v) for v in b.voices], b.path)
    with pytest.raises(PError) as e:
        P.load_model_config(str(tmp_path / "none.toml"))
    assert int(e.value.code) == 1  # FILE_OPEN_ERROR


class RecordingEngine:
    """Stands in for a StreamEngine under a StreamHandle: the bank's size,
    the version, and every set_control call."""

    def __init__(self, n_speakers):
        self.bank = {"additive": np.zeros((n_speakers, 256), np.float32)}
        self.cfg = types.SimpleNamespace(spec=V20RC0)
        self.calls = []

    def set_control(self, idx, field, value):
        self.calls.append((idx, field, np.asarray(value)))


def _same_calls(a, b):
    assert [(i, f) for i, f, _ in a] == [(i, f) for i, f, _ in b]
    for (_, field, x), (_, _, y) in zip(a, b):
        assert x.dtype == y.dtype, field
        np.testing.assert_allclose(x, y, atol=1e-7, rtol=0, err_msg=field)


@pytest.mark.parametrize("edits", sorted(EDITS))
def test_proxy_replay_and_lock_rules_drive_handles_alike(tmp_path, edits):
    """Each package's Controller applies the edits (Lock rules), its
    ProcessorProxy forwards the coupled updates to a StreamHandle of its
    package, then restores a saved state (a full replay with a model
    load): the control edits staged on the engine are the same."""
    card = _card(tmp_path, "good")
    runs = []
    for pkg, handle in ((J, JHandle), (P, PHandle)):
        engine = RecordingEngine(n_speakers=3)
        proxy = pkg.ProcessorProxy(lambda config: handle(engine, 1))
        assert proxy.load_model(card) == 0
        ui = pkg.Controller()
        ui.set_parameter(pkg.ParameterID.MODEL, card)
        for pid, value in EDITS[edits]:
            ui.set_parameter(int(pid), value)
            proxy.set_parameter(int(pid), value)
            for upd, v in ui.pop_updated_parameters():
                proxy.set_parameter(upd, v)
        proxy.parameter_state.set_value(pkg.ParameterID.MODEL, card)
        blob = proxy.state_bytes()
        assert proxy.restore_state_bytes(blob) == 0
        bad = [int(proxy.set_parameter(pkg.ParameterID.VOICE, 9)),
               int(proxy.set_parameter(pkg.ParameterID.PITCH_CORRECTION_TYPE, 2)),
               int(proxy.set_parameter(9999, 1.0))]
        runs.append((engine.calls, blob, bad))
    _same_calls(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert runs[0][2] == runs[1][2]


def test_voice_morph_state_alike():
    s = J.ParameterState()
    s.set_default_values(J.SCHEMA)
    s.set_value(J.ParameterID.VOICE_MORPH_CURSOR_X, 0.7)
    s.set_value(J.ParameterID.VOICE_MORPH_FALLOFF, 0.0)
    ps = P.ParameterState.from_bytes(s.to_bytes(), P.SCHEMA)
    a, b = J.get_voice_morph_state(s), P.get_voice_morph_state(ps)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    np.testing.assert_array_equal(a.calculate_weights(), b.calculate_weights())
    assert J.get_voice_morph_parameter_values(a) == P.get_voice_morph_parameter_values(b)
    buf = io.BytesIO()
    ps.write(buf)
    assert buf.getvalue() == s.to_bytes()
