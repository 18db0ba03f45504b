"""CLI driver (python -m tpu_snappy) — in-process main() invocations.

Small inputs ride the host fast-path, so these cover argument wiring,
container selection (raw / --framed / --hadoop), and the roundtrip exit
code without paying device dispatches."""

import pytest

from tpu_snappy.__main__ import main
from tpu_snappy import framing, hadoop
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


@pytest.fixture()
def sample(tmp_path):
    p = tmp_path / "in.txt"
    p.write_bytes(corpus.synth("text", 4600, 40))
    return p


def test_cli_roundtrip_exit_code(sample):
    assert main(["roundtrip", str(sample)]) == 0


def test_cli_compress_decompress_raw(sample, tmp_path, capsys):
    comp, back = tmp_path / "o.sz", tmp_path / "o.txt"
    assert main(["compress", str(sample), str(comp)]) == 0
    assert golden.uncompress(comp.read_bytes()) == sample.read_bytes()
    assert main(["decompress", str(comp), str(back)]) == 0
    assert back.read_bytes() == sample.read_bytes()
    assert "ratio" in capsys.readouterr().out


def test_cli_framed(sample, tmp_path):
    comp, back = tmp_path / "o.szf", tmp_path / "o.txt"
    assert main(["compress", str(sample), str(comp), "--framed"]) == 0
    assert framing.decompress(comp.read_bytes()) == sample.read_bytes()
    assert main(["decompress", str(comp), str(back), "--framed"]) == 0
    assert back.read_bytes() == sample.read_bytes()


def test_cli_fast_and_sidecar(sample, tmp_path):
    comp, back = tmp_path / "o.sz", tmp_path / "o.txt"
    assert main(["roundtrip", str(sample), "--fast"]) == 0
    assert main(["compress", str(sample), str(comp), "--framed",
                 "--sidecar", "always", "--fast"]) == 0
    assert framing.decompress(comp.read_bytes()) == sample.read_bytes()
    assert main(["decompress", str(comp), str(back), "--framed"]) == 0
    assert back.read_bytes() == sample.read_bytes()


def test_cli_turbo(sample, tmp_path):
    assert main(["roundtrip", str(sample), "--turbo"]) == 0
    assert main(["roundtrip", str(sample), "--ultra"]) == 0
    with pytest.raises(SystemExit):
        main(["roundtrip", str(sample), "--fast", "--turbo"])
    with pytest.raises(SystemExit):
        main(["roundtrip", str(sample), "--turbo", "--ultra"])


def test_cli_hadoop(sample, tmp_path):
    comp, back = tmp_path / "o.snappy", tmp_path / "o.txt"
    assert main(["compress", str(sample), str(comp), "--hadoop"]) == 0
    assert hadoop.decompress(comp.read_bytes()) == sample.read_bytes()
    assert main(["decompress", str(comp), str(back), "--hadoop"]) == 0
    assert back.read_bytes() == sample.read_bytes()


def test_cli_container_flags_exclusive(sample, tmp_path):
    with pytest.raises(SystemExit):
        main(["compress", str(sample), str(tmp_path / "x"),
              "--framed", "--hadoop"])
    with pytest.raises(SystemExit):
        main(["compress", str(sample), str(tmp_path / "x"),
              "--hadoop", "--mesh", "2"])


def test_cli_roundtrip_mismatch_path(tmp_path):
    # A directory path triggers a clean error rather than silent success.
    with pytest.raises(IsADirectoryError):
        main(["roundtrip", str(tmp_path)])