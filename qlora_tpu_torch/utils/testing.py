"""Test and smoke helpers that ship with the package: a tokenizer that
needs no files, so a training run can start from a dataset file on a
machine without ``transformers``."""


class FakeTokenizer:
    """Byte-level tokenizer: ids = bytes + 3 specials (pad 0, bos 1, eos 2).
    No files, no network.

    Satisfies the collator protocol; used by the tests and by
    ``chip_smoke.py``'s train-data phase."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0

    def encode(self, text: str):
        return [3 + b for b in text.encode()]

    def decode(self, ids, skip_special_tokens: bool = True):
        # a model's vocabulary may be wider than the 259 ids used here, and an
        # untrained model emits any id: ids outside the byte range decode to nothing
        return bytes(i - 3 for i in ids if 3 <= i < 259).decode(errors="replace")


class ShownTokenizer(FakeTokenizer):
    """``FakeTokenizer`` whose decode also shows the ids outside the byte
    range, each as ``<id>``, so that an untrained model's text tells its
    tokens apart (``FakeTokenizer`` decodes them to nothing).  Used where
    printed text stands for the tokens, as in ``chip_smoke.py``'s examples
    phase."""

    def decode(self, ids, skip_special_tokens: bool = True):
        out, run = [], []
        for i in list(ids) + [None]:
            if i is not None and 3 <= i < 259:
                run.append(i)
                continue
            out.append(super().decode(run))
            run = []
            if i is not None and i >= 259:
                out.append(f"<{i}>")
        return "".join(out)
