"""``launch/ablate_attention.py`` takes parts out of the hd-80 attention
kernels by exact line: every line it edits must still stand in the
sources as it expects, or its copies would time the whole kernels under
another name.  CPU only: the copies are made, not built."""
import pytest

from repro_torch.launch import ablate_attention as ab


@pytest.mark.parametrize("part", list(ab.EDITS))
def test_every_ablation_edit_still_matches_the_sources(part, tmp_path):
    root = ab.make_tree(tmp_path, part)
    for name, line, new in ab.EDITS[part]:
        before = (ab.SRC / name).read_text()
        after = (root / name).read_text()
        assert before.count(line + "\n") >= 1, (part, line)
        assert after.count(line + "\n") == 0, (part, line)
        if new:
            assert after.count(new + "\n") >= before.count(line + "\n")
    # nothing but the listed files changes
    edited = {name for name, _, _ in ab.EDITS[part]}
    for path in (ab.SRC / "repro_torch" / "csrc").iterdir():
        rel = f"repro_torch/csrc/{path.name}"
        if path.is_file() and rel not in edited:
            assert (root / rel).read_bytes() == path.read_bytes(), rel
