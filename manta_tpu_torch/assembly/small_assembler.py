"""Legacy greedy de-Bruijn assembler ("SmallAssembler").

Behavioral parity with the reference's legacy runSmallAssembler
(reference: src/c++/lib/assembly/SmallAssembler.cpp:622, options
src/c++/lib/options/SmallAssemblerOptions.hpp:24). This is the
pre-iterative algorithm the reference retains alongside
IterativeAssembler; it is unreachable from the production workflow
there and here, but kept for debug use (tools/test_assembler --small)
and reference parity.

Differences from the production iterative assembler
(manta_tpu/assembly/assembler.py): no pseudo-read rollover across word
sizes, one contig per outer iteration (longest over all max-count
seeds), a per-walk shared seen-vertex set across both extension
directions, repeat-containing reads only filtered at the last word
size, and a min-seed-read gate on the seed k-mer's read count.

Determinism note: the reference iterates an unordered_map to collect
max-count seed words (SmallAssembler.cpp:524) but stores them in an
ordered std::set, so the walk order (lexicographic) is deterministic;
we match that by sorting.
"""

from __future__ import annotations

from dataclasses import dataclass

from .assembler import AssembledContig, AssemblyReadInfo


@dataclass
class SmallAssemblerOptions:
    """(reference: options/SmallAssemblerOptions.hpp:24-53)."""
    alphabet: str = "ACGT"
    min_qval: int = 5
    min_word_length: int = 41
    max_word_length: int = 76
    word_step_size: int = 5
    min_contig_length: int = 15
    min_coverage: int = 1
    min_conservative_coverage: int = 2
    max_error: float = 0.35
    min_seed_reads: int = 3
    max_assembly_iterations: int = 10


def _get_end(contig: str, length: int, is_end: bool) -> str:
    return contig[-length:] if is_end else contig[:length]


def _add_base(contig: str, base: str, is_end: bool) -> str:
    return contig + base if is_end else base + contig


def _get_kmer_counts(reads, read_info, word_length, is_find_repeat_reads):
    """(reference: SmallAssembler.cpp:414-476).

    Returns (ok, repeat_reads, word_count, word_reads,
    read_word_offsets); ok is False when a word repeats within a read
    and repeats are not being collected (retry with a larger k), or
    when repeats were collected.
    """
    word_count: dict[str, int] = {}
    word_reads: dict[str, set[int]] = {}
    read_word_offsets: list[dict[str, int]] = [{} for _ in reads]
    repeat_reads: list[int] = []

    for read_index, seq in enumerate(reads):
        if read_info[read_index].is_used:
            continue
        read_len = len(seq)
        if read_len < word_length:
            continue
        offsets = read_word_offsets[read_index]
        for j in range(read_len - word_length + 1):
            word = seq[j:j + word_length]
            if "N" in word:
                continue
            if word in offsets:
                if is_find_repeat_reads:
                    repeat_reads.append(read_index)
                    break
                return False, repeat_reads, word_count, word_reads, \
                    read_word_offsets
            offsets[word] = j
        # a repeat read's partially collected words are still counted
        # (the reference's break falls through to the counting loop,
        # SmallAssembler.cpp:453-472)
        for word in offsets:
            word_count[word] = word_count.get(word, 0) + 1
            word_reads.setdefault(word, set()).add(read_index)

    return (not repeat_reads), repeat_reads, word_count, word_reads, \
        read_word_offsets


def _walk(opt: SmallAssemblerOptions, seed: str, word_length: int,
          word_count: dict[str, int], word_reads: dict[str, set[int]],
          seen_edge_before: set[str]) -> AssembledContig:
    """Greedy bidirectional extension (reference: SmallAssembler.cpp:144)."""
    contig = AssembledContig()
    contig.support_reads = set(word_reads[seed])
    contig.seq = seed

    # rejecting reads from the unselected branches of the seed's last base
    for symbol in opt.alphabet:
        if symbol == seed[word_length - 1]:
            continue
        new_key = _get_end(seed, word_length - 1, False) + symbol
        unselected = word_reads.get(new_key)
        if unselected:
            contig.reject_reads.update(unselected)

    seen_edge_before.clear()
    seen_edge_before.add(seed)
    seen_vertex_before: set[str] = set()

    conservative_end = 0
    conservative_beg = 0
    for mode in range(2):
        conservative_offset = 0
        is_end = mode == 0
        while True:
            previous_word = _get_end(contig.seq, word_length, is_end)
            trunk = _get_end(contig.seq, word_length - 1, is_end)
            if trunk in seen_vertex_before:
                break
            seen_vertex_before.add(trunk)

            max_base_count = 0
            max_shared_count = 0
            max_base = opt.alphabet[0]
            max_word_reads: set[int] = set()
            max_shared_reads: set[int] = set()
            support_to_remove: set[int] = set()
            reject_to_add: set[int] = set()

            for symbol in opt.alphabet:
                new_key = _add_base(trunk, symbol, is_end)
                curr_count = word_count.get(new_key)
                if curr_count is None:
                    continue
                curr_reads = word_reads.get(new_key)
                if curr_reads is None:
                    continue
                shared = contig.support_reads & curr_reads
                if not shared:
                    continue
                if len(shared) > max_shared_count:
                    # demote the previous best branch
                    support_to_remove.update(max_shared_reads)
                    reject_to_add.update(max_word_reads)
                    max_word_reads = curr_reads
                    max_shared_count = len(shared)
                    max_shared_reads = shared
                    max_base_count = curr_count
                    max_base = symbol
                else:
                    support_to_remove.update(shared)
                    reject_to_add.update(curr_reads)

            if max_base_count < opt.min_coverage or max_base_count == 0:
                break

            seen_edge_before.add(_add_base(trunk, max_base, is_end))
            contig.seq = _add_base(contig.seq, max_base, is_end)
            if conservative_offset != 0 or \
                    max_base_count < opt.min_conservative_coverage:
                conservative_offset += 1

            # one-step backward branch check (reference compares against
            # a previousWordReads set declared inside the loop, i.e.
            # always empty, so the check always fires when a branch was
            # selected; SmallAssembler.cpp:228,320)
            tmp_symbol = previous_word[0] if is_end else \
                previous_word[word_length - 1]
            for symbol in opt.alphabet:
                if symbol == tmp_symbol:
                    continue
                back_reads = word_reads.get(
                    _add_base(trunk, symbol, not is_end))
                if back_reads:
                    reject_to_add.update(back_reads)

            contig.reject_reads.update(reject_to_add)
            for rd in max_word_reads:
                if rd not in contig.reject_reads:
                    contig.support_reads.add(rd)
            contig.support_reads -= support_to_remove

        if mode == 0:
            conservative_end = conservative_offset
        else:
            conservative_beg = conservative_offset

    contig.conservative_beg = conservative_beg
    contig.conservative_end = len(contig.seq) - conservative_end
    return contig


def _build_contigs(opt: SmallAssemblerOptions, is_last_word: bool, reads,
                   read_info, word_length: int, contigs,
                   unused_reads: int) -> tuple[bool, int]:
    """(reference: SmallAssembler.cpp:478-620). Returns (ok, unused)."""
    ok, repeat_reads, word_count, word_reads, read_word_offsets = \
        _get_kmer_counts(reads, read_info, word_length, is_last_word)
    if not ok:
        if is_last_word:
            for read_index in repeat_reads:
                read_info[read_index].is_used = True
                read_info[read_index].is_filtered = True
                unused_reads -= 1
        return False, unused_reads

    max_words: list[str] = []
    max_word_count = 0
    for word in sorted(word_count):
        count = word_count[word]
        if count < max_word_count:
            continue
        if count > max_word_count:
            max_words.clear()
            max_word_count = count
        max_words.append(word)
    if max_word_count < opt.min_coverage:
        return False, unused_reads

    contig = AssembledContig()
    max_word = ""
    seen_edge_before: set[str] = set()
    pending = list(max_words)
    while pending:
        max_word = pending.pop(0)
        new_contig = _walk(opt, max_word, word_length, word_count,
                           word_reads, seen_edge_before)
        if len(new_contig.seq) > len(contig.seq):
            contig = new_contig
        pending = [w for w in pending if w not in seen_edge_before]

    contig.seed_read_count = sum(
        1 for offsets in read_word_offsets if max_word in offsets)
    if contig.seed_read_count < opt.min_seed_reads:
        return False, unused_reads

    for read_index, rinfo in enumerate(read_info):
        if rinfo.is_used:
            continue
        if read_index in contig.support_reads:
            rinfo.is_used = True
            rinfo.contig_ids.append(len(contigs))
            unused_reads -= 1

    contigs.append(contig)
    return True, unused_reads


def run_small_assembler(opt: SmallAssemblerOptions, reads: list[str]
                        ) -> tuple[list[AssemblyReadInfo],
                                   list[AssembledContig]]:
    """(reference: SmallAssembler.cpp:622-685)."""
    assert len(opt.alphabet) > 1
    read_info = [AssemblyReadInfo() for _ in reads]
    contigs: list[AssembledContig] = []
    unused_reads = len(reads)

    for _ in range(opt.max_assembly_iterations):
        if unused_reads < opt.min_seed_reads:
            return read_info, contigs
        last_unused = unused_reads
        word_length = opt.min_word_length
        while word_length <= opt.max_word_length:
            is_last_word = word_length + opt.word_step_size > \
                opt.max_word_length
            ok, unused_reads = _build_contigs(
                opt, is_last_word, reads, read_info, word_length, contigs,
                unused_reads)
            if ok:
                break
            word_length += opt.word_step_size
        if unused_reads == last_unused:
            break

    return read_info, contigs
