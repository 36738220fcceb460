"""CLIP byte-pair-encoding tokenizer (self-contained implementation).

The port's own copy of `tunevlseg_tpu/data/tokenizer.py`, the same ids for
the same text; `regex` (for the CLIP pattern's Unicode classes) is imported
at first use.

Replaces two tokenization paths of the reference:
  * HF `AutoTokenizer.from_pretrained(CIDAS/clipseg-rd64)` used by the
    datasets (src/data/core_datasets/basedataset.py:50-69) — BOS/EOS 49406/
    49407, padding with the EOS token, attention mask;
  * the OpenAI `SimpleTokenizer` vendored for CRIS/DenseCLIP
    (denseclip/untils.py:68) — fixed 77-token context, zero padding.

The BPE algorithm and the standard CLIP vocabulary format
(`bpe_simple_vocab_16e6.txt.gz`) are public; the merges file itself ships
with every CLIP distribution and its path is supplied by config
(`vocab_path`) — no network access required. Since this environment has no
`ftfy`, CLIP text cleaning is a close approximation (double html-unescape +
NFC + whitespace collapse — ftfy's normalization IS NFC; see _clean_text),
oracled vs HF fast tokenizers incl. a non-ASCII battery. WordPiece uses
BERT's own cleaner (_bert_clean), NOT this one.
"""
from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np


def _regex():
    import regex
    return regex


@functools.lru_cache()
def _token_pattern():
    re = _regex()
    return re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        re.IGNORECASE,
    )

CONTEXT_LENGTH = 77


@functools.lru_cache()
def _byte_unicode_table() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    chars = printable[:]
    extra = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + extra)
            extra += 1
    return dict(zip(printable, (chr(c) for c in chars)))


def _clean_text(text: str, unescape: bool = False) -> str:
    """Text cleanup. Two reference behaviors, selected by `unescape`:

    * False (HF CLIPTokenizerFast, the CLIPSeg data path): NFC + whitespace
      collapse only — HF does NOT touch html entities ('&amp;' tokenizes
      literally; oracled in tests/test_clip_bpe_parity.py).
    * True (OpenAI SimpleTokenizer basic_clean, the CRIS/DenseCLIP path,
      clip/simple_tokenizer.py): double html-unescape first. ftfy's default
      normalization IS NFC — NFKC (used here pre-r4) folded full-width
      forms/ligatures/ellipsis and diverged on those classes. Mojibake
      REPAIR (ftfy's other half) is intentionally not replicated:
      garbage-encoded prompts tokenize as their literal bytes."""
    if unescape:
        text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    text = _regex().sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    """BPE tokenizer over the standard CLIP merges file.

    `vocab_layout="standard"` places the special tokens at the end
    (49406/49407 — OpenAI CLIP / HF CLIPTokenizer; used by CLIPSeg and CRIS).
    `vocab_layout="denseclip"` places them at 512/513 before the merge tokens,
    matching the tokenizer vendored for DenseCLIP in the reference
    (denseclip/untils.py:100-109)."""

    def __init__(self, vocab_path: Union[str, Path], lowercase: bool = True,
                 vocab_layout: str = "standard"):
        raw = Path(vocab_path).read_bytes()
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        lines = raw.decode("utf-8").split("\n")
        # line 0 is a version header; CLIP uses the first 48894 merge rules
        merge_lines = lines[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines if line]

        byte_table = _byte_unicode_table()
        self._byte_encoder = byte_table
        vocab = list(byte_table.values())
        vocab.extend(v + "</w>" for v in list(byte_table.values()))
        if vocab_layout == "denseclip":
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            vocab.extend("".join(m) for m in merges)
        elif vocab_layout == "standard":
            vocab.extend("".join(m) for m in merges)
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        else:
            raise ValueError(f"unknown vocab_layout {vocab_layout}")

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self._merge_ranks = {m: i for i, m in enumerate(merges)}
        self._cache: dict[str, tuple[str, ...]] = {}
        self.lowercase = lowercase

        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)

    # -- BPE core -----------------------------------------------------------

    def _bpe(self, token: str) -> tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self._merge_ranks.get(p, 1 << 30))
            if best not in self._merge_ranks:
                break
            merged = []
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1
                        and (parts[i], parts[i + 1]) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = tuple(merged)
        self._cache[token] = parts
        return parts

    def encode(self, text: str, add_special_tokens: bool = True,
               clean: str = "hf") -> list[int]:
        text = _clean_text(text, unescape=(clean == "openai"))
        if self.lowercase:
            text = text.lower()
        ids: list[int] = []
        for word in _token_pattern().findall(text):
            if word in ("<|startoftext|>", "<|endoftext|>"):
                # literal special tokens in text map to their ids, matching
                # both HF (added-token matching) and OpenAI SimpleTokenizer
                # (cache pre-seeded with the specials)
                ids.append(self.encoder[word])
                continue
            as_unicode = "".join(self._byte_encoder[b]
                                 for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(as_unicode))
        if add_special_tokens:
            return [self.bos_token_id, *ids, self.eos_token_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids
                       if i not in (self.bos_token_id, self.eos_token_id))
        table = {v: k for k, v in self._byte_encoder.items()}
        raw = bytes(table[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -- batch APIs ---------------------------------------------------------

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        max_length: int = CONTEXT_LENGTH,
        padding: str = "max_length",
        style: str = "hf",
    ) -> dict[str, np.ndarray]:
        """Tokenize to fixed-shape int32 arrays.

        style="hf": pad with the EOS id + attention mask (HF CLIPTokenizer —
        the CLIPSeg path). style="openai": pad with 0, no mask needed by the
        caller (the CRIS path derives its pad mask from `ids == 0`).
        Truncation keeps the EOS in the final slot (HF truncates then appends
        EOS; OpenAI overwrites the last slot with EOS).
        """
        if isinstance(texts, str):
            texts = [texts]
        pad_id = self.eos_token_id if style == "hf" else 0
        n = len(texts)
        if padding == "max_length":
            width = max_length
        else:  # "longest" — still deterministic per batch
            width = min(max_length,
                        max(len(self.encode(t, clean=style)) for t in texts))
        input_ids = np.full((n, width), pad_id, np.int32)
        attention_mask = np.zeros((n, width), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, clean=style)
            if len(ids) > width:
                ids = ids[:width]
                ids[-1] = self.eos_token_id
            input_ids[i, :len(ids)] = ids
            attention_mask[i, :len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


class WordPieceTokenizer:
    """BERT WordPiece tokenizer (the BiomedCLIP text side).

    Replaces `AutoTokenizer.from_pretrained(microsoft/BiomedNLP-BiomedBERT-
    base-uncased-abstract)` from the reference's zsseg_biomedclip experiment
    (configs/experiment/zsseg_biomedclip.yaml:63): basic tokenization
    (lowercase, accent-strip, punctuation split) + greedy longest-match
    WordPiece over a standard `vocab.txt`. Emits [CLS] ... [SEP] with 0
    ([PAD]) padding and an attention mask — the contract
    `BiomedCLIP.get_text_features` expects (pad_token_id 0)."""

    def __init__(self, vocab_path: Union[str, Path], lowercase: bool = True,
                 max_input_chars_per_word: int = 100):
        lines = Path(vocab_path).read_text(encoding="utf-8").split("\n")
        self.encoder = {tok: i for i, tok in enumerate(lines) if tok}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.lowercase = lowercase
        self.max_word_chars = max_input_chars_per_word
        self.pad_token_id = self.encoder.get("[PAD]", 0)
        self.cls_token_id = self.encoder["[CLS]"]
        self.sep_token_id = self.encoder["[SEP]"]
        self.unk_token_id = self.encoder["[UNK]"]
        self.vocab_size = len(self.encoder)

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
                or 123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        """BERT BasicTokenizer's CJK ideograph ranges — each such char is
        space-padded into its OWN word before wordpiece (so unknown CJK
        yields one [UNK] per character, oracled vs BertTokenizerFast)."""
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    @staticmethod
    def _bert_clean(text: str) -> str:
        """BERT BasicTokenizer._clean_text semantics: drop NUL/U+FFFD and
        control chars, map whitespace forms to ' '. NO html unescaping and
        NO unicode normalization — those are CLIP's basic_clean (ftfy), and
        applying them here diverged from BertTokenizerFast on entities like
        '&amp;' (r4 code-review finding; oracled in
        tests/test_wordpiece_parity.py)."""
        out = []
        for ch in text:
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if cp == 0 or cp == 0xFFFD or (cat.startswith("C")
                                           and ch not in "\t\n\r"):
                continue
            out.append(" " if (ch in " \t\n\r" or cat == "Zs") else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> list[str]:
        text = self._bert_clean(text)
        text = "".join(f" {c} " if self._is_cjk(ord(c)) else c for c in text)
        if self.lowercase:
            text = text.lower()
            # strip accents (BERT uncased behavior)
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        words: list[str] = []
        for tok in text.split():
            buf = ""
            for ch in tok:
                if self._is_punct(ch):
                    if buf:
                        words.append(buf)
                        buf = ""
                    words.append(ch)
                else:
                    buf += ch
            if buf:
                words.append(buf)
        return words

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_token_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.encoder:
                    cur = self.encoder[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_token_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [i for w in self._basic_tokenize(text)
               for i in self._wordpiece(w)]
        if add_special_tokens:
            return [self.cls_token_id, *ids, self.sep_token_id]
        return ids

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        max_length: int = 256,
        padding: str = "max_length",
        style: str = "bert",
    ) -> dict[str, np.ndarray]:
        """Same batch contract as CLIPTokenizer.__call__; `style` is accepted
        for interchangeability and ignored (BERT always pads with [PAD] and
        keeps [SEP] in the final slot on truncation)."""
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        if padding == "max_length":
            width = max_length
        else:
            width = min(max_length,
                        max(len(self.encode(t)) for t in texts))
        input_ids = np.full((n, width), self.pad_token_id, np.int32)
        attention_mask = np.zeros((n, width), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            if len(ids) > width:
                ids = ids[:width]
                ids[-1] = self.sep_token_id
            input_ids[i, :len(ids)] = ids
            attention_mask[i, :len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


class SigLIPTokenizer:
    """SentencePiece-unigram tokenizer with SigLIP semantics, self-contained.

    Replaces HF `SiglipTokenizer` (transformers/models/siglip/
    tokenization_siglip.py), which the reference reaches through
    `AutoTokenizer` for the TransformerSegmentor's SigLIP encoder
    (src/models/core_models/trans_segmentor/encoder.py:20-115,
    src/data/core_datasets/basedataset.py:50-69). That class needs the
    `sentencepiece` binary wheel; this one parses the standard
    `spiece.model` ModelProto directly (minimal protobuf wire reader — the
    relevant schema is stable: repeated SentencePiece{piece=1, score=2,
    type=3} at field 1) and runs unigram Viterbi segmentation in Python.

    Pipeline parity with the HF slow tokenizer:
      * lowercase (`do_lower_case=True` default),
      * `canonicalize_text`: strip ASCII punctuation, collapse whitespace
        (big_vision prompt_engineering semantics),
      * leading `▁` prefix, spaces → `▁` (add_dummy_prefix disabled — the
        prefix is added EXPLICITLY by SiglipTokenizer.tokenize),
      * unigram Viterbi: maximize summed piece log-probs; unknown chars get
        `min_score - 10` (sentencepiece's kUnkPenalty) and consecutive
        unknowns fuse into one `<unk>` (sentencepiece/HF-fast `fuse_unk`),
      * `</s>` appended; pad with `</s>` (= pad token) to max_length 64.
    NFKC here approximates the model's precompiled nmt_nfkc charsmap —
    exact for ASCII prompts (the framework's datasets), same caveat as the
    ftfy approximation above.
    """

    SPIECE_UNDERLINE = "▁"
    _NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = range(1, 7)

    def __init__(self, vocab_path: Union[str, Path], lowercase: bool = True,
                 max_length: int = 64):
        pieces = self._parse_model_proto(Path(vocab_path).read_bytes())
        if not pieces:
            raise ValueError(f"no sentencepiece pieces in {vocab_path}")
        self.pieces = pieces
        self.lowercase = lowercase
        self.max_length = max_length
        # matchable surface vocab: NORMAL + USER_DEFINED pieces only
        # (control/unknown pieces never match raw text)
        self._vocab: dict[str, tuple[int, float]] = {}
        self._max_piece_len = 1
        unk_id = 0
        min_score = 0.0
        for i, (piece, score, ptype) in enumerate(pieces):
            if ptype == self._UNKNOWN:
                unk_id = i
            if ptype in (self._NORMAL, self._USER_DEFINED):
                self._vocab[piece] = (i, score)
                self._max_piece_len = max(self._max_piece_len, len(piece))
                min_score = min(min_score, score)
        self.unk_token_id = unk_id
        self._unk_score = min_score - 10.0     # sentencepiece kUnkPenalty
        ids = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.eos_token_id = ids.get("</s>", 1)
        self.pad_token_id = self.eos_token_id  # HF SiglipTokenizer: pad=</s>
        self.decoder = {i: p for i, (p, _, _) in enumerate(pieces)}
        self.vocab_size = len(pieces)

    # -- model file ---------------------------------------------------------

    @classmethod
    def _parse_model_proto(cls, data: bytes):
        """Minimal ModelProto reader: [(piece, score, type), ...]."""
        import struct

        def varint(buf, i):
            shift = out = 0
            while True:
                b = buf[i]
                i += 1
                out |= (b & 0x7F) << shift
                if not b & 0x80:
                    return out, i
                shift += 7

        def skip(buf, i, wire):
            if wire == 0:
                return varint(buf, i)[1]
            if wire == 1:
                return i + 8
            if wire == 2:
                ln, i = varint(buf, i)
                return i + ln
            if wire == 5:
                return i + 4
            raise ValueError(f"unsupported protobuf wire type {wire}")

        pieces = []
        i = 0
        while i < len(data):
            tag, i = varint(data, i)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:       # repeated SentencePiece
                ln, i = varint(data, i)
                sub, i = data[i:i + ln], i + ln
                piece, score, ptype = "", 0.0, cls._NORMAL
                j = 0
                while j < len(sub):
                    t, j = varint(sub, j)
                    f, w = t >> 3, t & 7
                    if f == 1 and w == 2:
                        l2, j = varint(sub, j)
                        piece = sub[j:j + l2].decode("utf-8")
                        j += l2
                    elif f == 2 and w == 5:
                        score = struct.unpack("<f", sub[j:j + 4])[0]
                        j += 4
                    elif f == 3 and w == 0:
                        ptype, j = varint(sub, j)
                    else:
                        j = skip(sub, j, w)
                pieces.append((piece, score, ptype))
            else:
                i = skip(data, i, wire)
        return pieces

    # -- text pipeline ------------------------------------------------------

    _PUNCT_TABLE = str.maketrans(
        "", "", r"""!"#$%&'()*+,-./:;<=>?@[\]^_`{|}~""")  # string.punctuation

    def canonicalize_text(self, text: str) -> str:
        """big_vision canonicalization (HF SiglipTokenizer.canonicalize_text):
        ASCII punctuation removed, whitespace collapsed + stripped."""
        text = text.translate(self._PUNCT_TABLE)
        return _regex().sub(r"\s+", " ", text).strip()

    def _viterbi(self, s: str) -> list[int]:
        """Best unigram segmentation of `s` (▁-escaped, no specials)."""
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int]] = [(0, 0)] * (n + 1)  # (start, piece_id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_piece_len)
            for j in range(i + 1, hi + 1):
                hit = self._vocab.get(s[i:j])
                if hit is not None:
                    sc = best[i] + hit[1]
                    if sc > best[j]:
                        best[j], back[j] = sc, (i, hit[0])
            # single-char unknown fallback keeps the lattice connected
            sc = best[i] + self._unk_score
            if sc > best[i + 1]:
                best[i + 1], back[i + 1] = sc, (i, self.unk_token_id)
        out: list[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            out.append(pid)
            j = i
        out.reverse()
        # sentencepiece fuses runs of unknown chars into ONE <unk>
        fused: list[int] = []
        for pid in out:
            if (pid == self.unk_token_id and fused
                    and fused[-1] == self.unk_token_id):
                continue
            fused.append(pid)
        return fused

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        text = unicodedata.normalize("NFKC", text)
        # SiglipTokenizer.tokenize: explicit ▁ prefix, existing ▁ -> space
        text = self.SPIECE_UNDERLINE + text.replace(self.SPIECE_UNDERLINE, " ")
        if self.lowercase:
            text = text.lower()
        text = self.canonicalize_text(text)
        s = text.replace(" ", self.SPIECE_UNDERLINE)
        ids = self._viterbi(s) if s else []
        if add_special_tokens:
            return [*ids, self.eos_token_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        specials = {self.eos_token_id, self.pad_token_id}
        text = "".join(self.decoder[i] for i in ids
                       if i not in specials and i in self.decoder)
        return text.replace(self.SPIECE_UNDERLINE, " ").strip()

    # -- batch API (same contract as CLIPTokenizer) -------------------------

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        max_length: Optional[int] = None,
        padding: str = "max_length",
        style: str = "siglip",
    ) -> dict[str, np.ndarray]:
        """Fixed-shape int32 arrays; pads with `</s>` per SigLIP convention.

        `max_length` is CLAMPED to the model_max_length (64): the SigLIP
        text tower has exactly 64 position embeddings, and a dataset-level
        default of 77 (the CLIP convention) would make the position gather
        run out of range — the NaN-fill failure mode of the tiny-vocab bug."""
        if isinstance(texts, str):
            texts = [texts]
        width = min(max_length or self.max_length, self.max_length)
        encoded = [self.encode(t) for t in texts]
        if padding != "max_length":
            width = min(width, max(len(ids) for ids in encoded))
        n = len(texts)
        input_ids = np.full((n, width), self.pad_token_id, np.int32)
        attention_mask = np.zeros((n, width), np.int32)
        for i, ids in enumerate(encoded):
            if len(ids) > width:
                ids = ids[:width]
                ids[-1] = self.eos_token_id
            input_ids[i, :len(ids)] = ids
            attention_mask[i, :len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


TOKENIZER_FAMILIES = {
    "clip": CLIPTokenizer,
    "wordpiece": WordPieceTokenizer,
    "siglip": SigLIPTokenizer,
}


DEFAULT_VOCAB_CANDIDATES = (
    Path(__file__).resolve().parents[2] / "assets" / "bpe_simple_vocab_16e6.txt.gz",
)


def load_default_tokenizer(vocab_path: Optional[Union[str, Path]] = None,
                           family: str = "clip"):
    """Build the configured tokenizer family (the reference's AutoTokenizer
    seam, basedataset.py:50-69): "clip" BPE (CLIPSeg/CRIS), "siglip"
    sentencepiece-unigram over a `spiece.model`, "wordpiece" BERT vocab.txt
    (BiomedCLIP)."""
    if family != "clip":
        if vocab_path is None:
            raise FileNotFoundError(
                f"tokenizer family {family!r} requires `vocab_path` "
                "(spiece.model / vocab.txt)")
        return TOKENIZER_FAMILIES[family](vocab_path)
    if vocab_path is not None:
        return CLIPTokenizer(vocab_path)
    for cand in DEFAULT_VOCAB_CANDIDATES:
        if Path(cand).exists():
            return CLIPTokenizer(cand)
    raise FileNotFoundError(
        "No CLIP BPE vocab found. Provide `vocab_path` pointing at "
        "bpe_simple_vocab_16e6.txt.gz (ships with every CLIP distribution).")
