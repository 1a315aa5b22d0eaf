"""The port's config system (``radio_mapper_tpu_torch.config``) against the
JAX package's (``radio_mapper_tpu.config``).

The schema is the on-disk YAML format both packages share, so: equal
defaults (``config_to_dict``), equal env expansion and coercion, equal
deep merge, the same validation errors, and YAML written by either package
loading in the other to an equal dict. The ``tpu:`` section keeps its
name in the port: it is part of the file format.

Tolerance: exact.
"""

import dataclasses

import pytest

from radio_mapper_tpu import config as jconfig
from radio_mapper_tpu.config import loader as jloader

from radio_mapper_tpu_torch import config
from radio_mapper_tpu_torch.config import loader
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

SECTIONS = ["BuoyConfig", "EmergencyConfig", "GpsConfig", "LoggingConfig", "SdrConfig", "ServerConfig",
            "SignalDetectionConfig", "StorageConfig", "TdoaConfig", "TimingConfig", "TpuConfig", "WebConfig"]


def _plain(x):
    """Dataclasses as dicts, sequences as lists: comparable across packages."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def test_exports_and_defaults_equal():
    assert sorted(config.__all__) == sorted(jconfig.__all__)
    assert config.config_to_dict(config.Config()) == jconfig.config_to_dict(jconfig.Config())
    for name in SECTIONS:
        ours, ref = getattr(config, name), getattr(jconfig, name)
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)], name
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref()), name
    cfg, jcfg = config.Config().validate(), jconfig.Config().validate()
    assert "tpu" in config.config_to_dict(cfg)
    for path in ("sdr.sample_rate", "buoy.gps.device", "tpu.block_len", "tdoa.minimum_buoys",
                 "signal_detection.priority_schedule", "nope.nope", "sdr", "web.port.x"):
        assert _plain(cfg.get(path, "fallback")) == _plain(jcfg.get(path, "fallback")), path
    for rate in (250_000.0, 1_024_000.0, 2_048_000.0, 3_200_000.0):
        assert cfg.tdoa.max_lag_samples(rate) == jcfg.tdoa.max_lag_samples(rate)


@pytest.mark.parametrize("value", [
    "${RMT_T18_A:-8081}", "${RMT_T18_A}", "${RMT_T18_B:-true}", "${RMT_T18_B:-False}", "${RMT_T18_C:-2.5}",
    "${RMT_T18_C:-x}", "ws://h:${RMT_T18_A:-8081}/p", "${RMT_T18_UNSET}", "plain", " ${RMT_T18_A:-1} ",
    ["${RMT_T18_A:-1}", {"k": "${RMT_T18_D:-1e3}"}], {"a": {"b": "${RMT_T18_A:-7}"}}, 12, None, 1.5,
])
@pytest.mark.parametrize("env", [{}, {"RMT_T18_A": "9000", "RMT_T18_B": "TRUE", "RMT_T18_C": "-3",
                                      "RMT_T18_D": "word"}])
def test_env_expansion_and_coercion(monkeypatch, value, env):
    for k in ("RMT_T18_A", "RMT_T18_B", "RMT_T18_C", "RMT_T18_D", "RMT_T18_UNSET"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, ref = config.expand_env(value), jconfig.expand_env(value)
    assert ours == ref and type(ours) is type(ref)


def test_deep_merge():
    cases = [({"a": {"b": 1, "c": 2}, "d": 3}, {"a": {"c": 20}, "e": 4}),
             ({"a": 1}, {"a": {"b": 2}}), ({"a": {"b": {"c": 1, "d": 2}}}, {"a": {"b": {"d": [3]}}}),
             ({}, {}), ({"x": [1, 2]}, {"x": {"y": 1}})]
    for base, over in cases:
        assert config.deep_merge(base, over) == jconfig.deep_merge(base, over)


BAD = [
    "sdr:\n  sample_rate: 99\n", "tdoa:\n  minimum_buoys: 2\n", "tpu:\n  fft_backend: cufft\n",
    "tpu:\n  gcc_weighting: gauss\n", "buoy:\n  location:\n    latitude: 91\n", "web:\n  port: 70000\n",
    "timing:\n  target_accuracy_microseconds: -1\n", "sdr: 3\n",
]


@pytest.mark.parametrize("text", BAD)
def test_validation_errors_agree(tmp_path, text):
    p = tmp_path / "bad.yaml"
    p.write_text(text)
    outcome = []
    for mod in (loader, jloader):
        try:
            outcome.append(("ok", mod.config_to_dict(mod.load_config(str(p)))))
        except Exception as e:  # compared across packages, class and message
            outcome.append((type(e).__name__, str(e)))
    assert outcome[0] == outcome[1]


def test_partial_yaml_and_overrides(tmp_path, monkeypatch):
    monkeypatch.setenv("RMT_T18_WS", "8099")
    p = tmp_path / "partial.yaml"
    p.write_text("sdr:\n  sample_rate: 2400000\ncentral_server:\n  websocket_port: ${RMT_T18_WS:-8085}\n"
                 "tdoa:\n  maximum_baseline_km: 25\ntpu:\n  mesh_shape: [2, 4]\n  num_channels: 8\n"
                 "signal_detection:\n  priority_schedule:\n    - {frequency: 121.5, duration: 5.0, priority: emergency}\n")
    over = {"web": {"port": "${RMT_T18_WS}"}, "buoy": {"name": "n"}}
    ours = loader.load_config(str(p), over)
    ref = jloader.load_config(str(p), over)
    assert loader.config_to_dict(ours) == jloader.config_to_dict(ref)
    assert list(ours.tpu.mesh_shape) == [2, 4] and ours.web.port == 8099 and ours.sdr.sample_rate == 2_400_000


@pytest.mark.parametrize("writer,reader", [(loader, jloader), (jloader, loader), (loader, loader)],
                         ids=["port_writes", "ref_writes", "port_both"])
def test_yaml_written_by_one_loads_in_the_other(tmp_path, writer, reader):
    p = str(tmp_path / "example.yaml")
    writer.generate_example_yaml(p)
    got = reader.load_config(p)
    assert reader.config_to_dict(got) == jloader.config_to_dict(jconfig.Config())
    assert reader.config_to_dict(got) == loader.config_to_dict(config.Config())


def test_example_yaml_bytes_equal(tmp_path):
    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    loader.generate_example_yaml(str(a))
    jloader.generate_example_yaml(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert b"\ntpu:\n" in a.read_bytes()


def test_global_accessor(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text("web:\n  port: 7100\n")
    config.reset_config()
    jconfig.reset_config()
    try:
        assert config.get_config().web.port == jconfig.get_config().web.port == 7100
        assert config.get_config() is config.get_config()
    finally:
        config.reset_config()
        jconfig.reset_config()
