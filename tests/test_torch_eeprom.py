"""The port's rtl_eeprom image codec (``radio_mapper_tpu_torch.tools.eeprom``)
against the JAX package's (``radio_mapper_tpu.tools.eeprom``).

Tolerance: exact. Images are byte-equal, parsed configs equal field for
field, ``format_config`` text equal, and the CLI ``main`` prints the same
lines and writes the same bytes on the same files. Random configs come
from numpy ``default_rng`` with a fixed seed.
"""

import dataclasses

import numpy as np
import pytest

from radio_mapper_tpu.tools import eeprom as jee

from radio_mapper_tpu_torch.tools import eeprom as ee
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _conf_pair(rng):
    """The same random config in both packages' dataclass."""
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefgh0123456789 -_"
    text = lambda n: "".join(rng.choice(list(alphabet), int(n)))
    kw = dict(
        vendor_id=int(rng.integers(0, 1 << 16)), product_id=int(rng.integers(0, 1 << 16)),
        manufacturer=text(rng.integers(0, 10)), product=text(rng.integers(0, 10)),
        serial=text(rng.integers(0, 9)), have_serial=bool(rng.integers(2)),
        enable_ir=bool(rng.integers(2)), remote_wakeup=bool(rng.integers(2)),
    )
    return ee.EepromConfig(**kw), jee.EepromConfig(**kw)


def test_constants_and_presets():
    assert (ee.EEPROM_SIZE, ee.STR_OFFSET, ee.STR_LIMIT, ee.HEADER) == (
        jee.EEPROM_SIZE, jee.STR_OFFSET, jee.STR_LIMIT, jee.HEADER)
    assert sorted(ee.DEFAULT_CONFIGS) == sorted(jee.DEFAULT_CONFIGS)
    for name in ee.DEFAULT_CONFIGS:
        assert dataclasses.asdict(ee.DEFAULT_CONFIGS[name]) == dataclasses.asdict(jee.DEFAULT_CONFIGS[name])
        assert ee.generate_image(ee.DEFAULT_CONFIGS[name]) == jee.generate_image(jee.DEFAULT_CONFIGS[name])
        assert ee.format_config(ee.DEFAULT_CONFIGS[name]) == jee.format_config(jee.DEFAULT_CONFIGS[name])


@pytest.mark.parametrize("seed", range(4))
def test_random_images_generate_and_parse(seed):
    rng = np.random.default_rng(seed)
    for _ in range(32):
        ours, ref = _conf_pair(rng)
        try:
            jimg = jee.generate_image(ref)
        except jee.EepromError as e:
            with pytest.raises(ee.EepromError, match=str(e)[:20]):
                ee.generate_image(ours)
            continue
        img = ee.generate_image(ours)
        assert img == jimg
        assert dataclasses.asdict(ee.parse_image(img)) == dataclasses.asdict(jee.parse_image(jimg))
        assert ee.format_config(ours) == jee.format_config(ref)


def test_parse_errors_agree():
    good = jee.generate_image(jee.DEFAULT_CONFIGS["realtek"])
    bads = [good[:100], bytes([0xFF]) + good[1:], good[:9] + bytes([200, 3]) + good[11:]]
    raised = 0
    for bad in bads:
        res = []
        for mod in (ee, jee):
            try:
                res.append(dataclasses.asdict(mod.parse_image(bad)))
            except Exception as e:  # compared below, class and message
                res.append((type(e).__name__, str(e)))
        assert res[0] == res[1]
        raised += isinstance(res[0], tuple)
    assert raised >= 2
    over = dataclasses.replace(ee.DEFAULT_CONFIGS["realtek"], product="X" * 40)
    with pytest.raises(ee.EepromError, match="too long"):
        ee.generate_image(over)


@pytest.mark.parametrize("argv", [
    ["--generate", "noxon", "--serial", "CAFE01", "--ir", "1"],
    ["--generate", "realtek", "--manufacturer", "Acme", "--product", "P", "--wakeup", "0"],
    ["--generate", "terratec_plus", "--serial", "7"],
])
def test_cli_run_on_the_same_files(tmp_path, capsys, argv):
    outs = []
    for tag, mod in (("ours", ee), ("ref", jee)):
        path = tmp_path / f"{tag}.bin"
        assert mod.main([*argv, "--out", str(path)]) == 0
        text = capsys.readouterr().out.replace(str(path), "X")
        assert mod.main(["--read", str(path)]) == 0
        outs.append((text, capsys.readouterr().out, path.read_bytes()))
    assert outs[0] == outs[1]
