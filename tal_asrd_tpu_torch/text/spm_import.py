"""SentencePiece .model importer (no sentencepiece / protobuf dependency).

Reference users hold trained sentencepiece files (taltoken-cased.model,
the reference's tokenizers/sentencepiece.py). This module parses the protobuf
wire format of sentencepiece's ModelProto directly and reconstructs an
equivalent native BpeModel:

  * ModelProto field 1 (repeated SentencePiece): piece=1 (string),
    score=2 (float), type=3 (enum: NORMAL=1, UNKNOWN=2, CONTROL=3, ...);
  * for a BPE-trained model the scores encode merge priority (higher score =
    earlier merge); merges are reconstructed by processing multi-character
    pieces in score order and splitting each into two already-known pieces;
  * special pieces map onto the reference id layout (bos=0/eos=1/pad=2/unk=3,
    its sentencepiece.py). Models trained with that exact layout keep their
    piece ids, so token ids match the reference's tokenizer bit-for-bit.

Only the fields needed for inference are read; unknown fields are skipped
per the protobuf wire rules.

Counterpart of tal_asrd_tpu/text/spm_import.py, on the port's BpeModel.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from tal_asrd_tpu_torch.text.bpe import SPECIALS, BpeModel


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _parse_sentencepiece(buf: bytes) -> Tuple[str, float, int]:
    """One SentencePiece message -> (piece, score, type)."""
    pos = 0
    piece, score, ptype = "", 0.0, 1
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            piece = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack("<f", buf[pos : pos + 4])
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """ModelProto -> [(piece, score, type)] in file order."""
    pos = 0
    out = []
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            n, pos = _read_varint(data, pos)
            out.append(_parse_sentencepiece(data[pos : pos + n]))
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    return out


NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE, UNUSED = 1, 2, 3, 4, 6, 5


def reconstruct_merges(pieces_scores: List[Tuple[str, float]]
                       ) -> Tuple[List[str], List[Tuple[str, str]]]:
    """BPE merge-table reconstruction from (piece, score) pairs.

    sentencepiece's BPE encoder repeatedly merges the adjacent symbol pair
    whose CONCATENATION is the piece with the best score — the merge is
    driven by the resulting piece, not by a recorded pair. To express that in
    a pair-rank table, every split p = a + b (a, b in the vocabulary) of a
    multi-character piece p gets a merge entry at p's score rank; the greedy
    lowest-rank encoder then behaves identically.
    """
    all_pieces = {p for p, _ in pieces_scores}
    chars = [p for p, _ in pieces_scores if len(p) == 1]
    multi = sorted(
        [(p, s) for p, s in pieces_scores if len(p) > 1], key=lambda t: -t[1]
    )
    merges: List[Tuple[str, str]] = []
    for p, _ in multi:
        for i in range(1, len(p)):
            a, b = p[:i], p[i:]
            if a in all_pieces and b in all_pieces:
                merges.append((a, b))
    return chars + [p for p, _ in multi], merges


def load_sentencepiece_model(path: str) -> BpeModel:
    """Parse a sentencepiece .model file into a native BpeModel.

    Models trained with --bos_id=0 --eos_id=1 --pad_id=2 --unk_id=3 (the
    reference recipe) keep their piece ids exactly: the 4 control pieces map
    onto our SPECIALS slots and the remaining pieces follow in file order.
    """
    with open(path, "rb") as f:
        entries = parse_model_proto(f.read())
    if not entries:
        raise ValueError(f"{path}: no sentencepiece entries found")

    normals = [(p, s) for p, s, t in entries if t in (NORMAL, USER_DEFINED, BYTE)]
    n_specials = sum(1 for _, _, t in entries if t in (UNKNOWN, CONTROL))
    if n_specials != len(SPECIALS):
        print(f"[spm_import] {path}: {n_specials} control pieces "
              f"(expected {len(SPECIALS)}); piece ids may shift")

    # Keep file order for ids; reconstruct merges from scores.
    _, merges = reconstruct_merges(normals)
    pieces = [p for p, _ in normals]
    model = BpeModel(pieces, merges)
    return model
