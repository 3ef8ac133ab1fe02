"""Corpus cleaning: raw corpus → clean corpus.

Port of ``textgcn_tpu/text/clean.py`` (pure Python, so the code is the
same), which reproduces the reference's recipe:

- regex clean: strip characters outside ``[A-Za-z0-9(),!?'`]``, split
  contractions ("it's" → "it 's", "don't" → "do n't", …), space out
  ``, ! ( ) ?``, collapse whitespace, lowercase;
- English stop-word removal, **skipped for the ``mr`` dataset**;
- drop words with corpus frequency < 5, also skipped for ``mr``;
- two passes: the first builds the words to keep, the second writes one
  cleaned document per line with the reference's trailing ``" \\n"``;
- input decoded as latin-1.

The stop words always come from the vendored list
(:mod:`textgcn_tpu_torch.text.stopwords`), so the output does not depend on
whether NLTK and its data are installed.

CLI: ``python -m textgcn_tpu_torch.text.clean --dataset R8`` (host work: it
needs no device).
"""
from __future__ import annotations

import os
import re
from collections import Counter
from typing import Iterable, List

from textgcn_tpu_torch.text.stopwords import NLTK_ENGLISH_STOPWORDS


class StringProcess:
    """Regex text normalizer."""

    def __init__(self):
        self.other_char = re.compile(r"[^A-Za-z0-9(),!?\'\`]")
        self.num = re.compile(r"[+-]?\d+\.?\d*")
        self.url = re.compile(
            r"(https?|ftp|file)://[-A-Za-z0-9+&@#/%?=~_|!:,.;]+"
            r"[-A-Za-z0-9+&@#/%=~_|]"
        )
        self.stop_words = NLTK_ENGLISH_STOPWORDS

    def clean_str(self, s: str) -> str:
        s = self.other_char.sub(" ", s)
        for pat, rep in (
            (r"\'s", " 's"),
            (r"\'ve", " 've"),
            (r"n\'t", " n't"),
            (r"\'re", " 're"),
            (r"\'d", " 'd"),
            (r"\'ll", " 'll"),
            (r",", " , "),
            (r"!", " ! "),
            # The reference's replacement strings are " \( " etc.; re.sub
            # leaves unknown non-letter escapes alone, so its cleaned corpora
            # hold the literal tokens "\(", "\)", "\?", and so do the clean
            # corpora the published accuracies were trained on. Reproduce
            # them byte for byte.
            (r"\(", r" \( "),
            (r"\)", r" \) "),
            (r"\?", r" \? "),
        ):
            s = re.sub(pat, rep, s)
        s = re.sub(r"\s{2,}", " ", s)
        return s.strip().lower()

    def remove_stopwords(self, s: str) -> str:
        return " ".join(w for w in s.split() if w not in self.stop_words)

    def replace_num(self, s: str) -> str:
        return self.num.sub("<num>", s)

    def replace_urls(self, s: str) -> str:
        s = self.url.sub("<url>", s)
        return " ".join(re.split(r" +|\n+", s)).strip()


def clean_corpus_lines(
    lines: Iterable[bytes],
    dataset: str,
    min_word_freq: int = 5,
) -> List[str]:
    """Clean raw corpus lines (bytes, decoded as latin-1, or str) by the
    reference's recipe; returns the cleaned documents."""
    sp = StringProcess()
    keep_stopword_filter = dataset not in {"mr"}

    cleaned = []
    for raw in lines:
        s = raw.strip().decode("latin1") if isinstance(raw, bytes) else raw.strip()
        s = sp.clean_str(s)
        if keep_stopword_filter:
            s = sp.remove_stopwords(s)
        cleaned.append(s)

    if keep_stopword_filter:
        counts: Counter = Counter()
        for s in cleaned:
            counts.update(s.split())
        keep = {w for w, c in counts.items() if c >= min_word_freq}
        cleaned = [" ".join(w for w in s.split() if w in keep) for s in cleaned]
    return cleaned


class CorpusProcess:
    """File-to-file cleaner: ``{data_root}/text_dataset/corpus/{ds}.txt`` →
    ``{data_root}/text_dataset/clean_corpus/{ds}.txt``."""

    def __init__(self, dataset: str, data_root: str = "data", run: bool = True):
        self.dataset = dataset
        self.corpus_name = os.path.join(data_root, "text_dataset", "corpus", f"{dataset}.txt")
        clean_dir = os.path.join(data_root, "text_dataset", "clean_corpus")
        os.makedirs(clean_dir, exist_ok=True)
        self.save_name = os.path.join(clean_dir, f"{dataset}.txt")
        if run:
            self.clean_text()

    def clean_text(self) -> None:
        with open(self.corpus_name, "rb") as fin:
            cleaned = clean_corpus_lines(fin, self.dataset)
        doc_lens = []
        with open(self.save_name, "w", encoding="utf-8") as fout:
            for s in cleaned:
                fout.write(s)
                fout.write(" \n")  # the reference's trailing space
                doc_lens.append(len(s.split()))
        avg = sum(doc_lens) / max(len(doc_lens), 1)
        print(f"Average length: {avg:.2f}")
        print(f"doc count: {len(doc_lens)}")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="clean a raw corpus")
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_root", default="data")
    args = p.parse_args(argv)
    CorpusProcess(args.dataset, data_root=args.data_root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
