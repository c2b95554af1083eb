"""Iterative greedy de-Bruijn assembler.

Behavioral parity with the reference runIterativeAssembler
(reference: src/c++/lib/assembly/IterativeAssembler.cpp): k-mer counting
with pseudo-read weighting, Tarjan SCC repeat detection with the
small-circle threshold, greedy bidirectional contig extension with
supporting/rejecting read tracking and branch-point backward checks,
word-size iteration 41..76 step 5 with pseudo-read rollover, and greedy
contig selection by new non-pseudo supporting reads.

One deliberate determinism fix: the reference's repeat search iterates
an unordered_map (platform-dependent order); here words are visited in
sorted order so results are reproducible everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AssemblerOptions:
    """(reference: options/IterativeAssemblerOptions.hpp:26-59)."""
    alphabet: str = "ACGT"
    min_qval: int = 5
    min_word_length: int = 41
    max_word_length: int = 76
    word_step_size: int = 5
    min_contig_length: int = 15
    min_coverage: int = 1
    min_conservative_coverage: int = 2
    max_error: float = 0.35
    min_unused_reads: int = 3
    min_support_reads: int = 2
    max_assembly_count: int = 10


@dataclass
class AssembledContig:
    seq: str = ""
    seed_read_count: int = 0
    support_reads: set[int] = field(default_factory=set)
    reject_reads: set[int] = field(default_factory=set)
    conservative_beg: int = 0
    conservative_end: int = 0


@dataclass
class AssemblyReadInfo:
    is_used: bool = False
    is_filtered: bool = False
    is_pseudo: bool = False
    contig_ids: list[int] = field(default_factory=list)


def _get_kmer_maps(opt: AssemblerOptions, reads: list[str],
                   read_info: list[AssemblyReadInfo], word_length: int):
    word_count: dict[str, int] = {}
    word_reads: dict[str, set[int]] = {}
    for read_index, seq in enumerate(reads):
        read_len = len(seq)
        if read_len < word_length:
            continue
        read_words = set()
        for j in range(read_len - word_length + 1):
            word = seq[j:j + word_length]
            if "N" in word:
                continue
            read_words.add(word)
        add = opt.min_coverage if read_info[read_index].is_pseudo else 1
        for word in read_words:
            word_count[word] = word_count.get(word, 0) + add
            word_reads.setdefault(word, set()).add(read_index)
    return word_count, word_reads


def _get_repeat_kmers(opt: AssemblerOptions, word_count: dict) -> set[str]:
    """Tarjan SCC over the kmer successor graph; members of non-singleton
    SCCs with DFS-index span <= 50 are repeat words, plus homopolymer
    self-loops (reference: IterativeAssembler.cpp:555-642). Iterative
    implementation (the reference recurses)."""
    repeat_words: set[str] = set()
    index_of: dict[str, int] = {}
    lowlink: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    next_index = 1

    def successors(word):
        tail = word[1:]
        out = []
        for symbol in opt.alphabet:
            nxt = tail + symbol
            if nxt == word:
                repeat_words.add(word)
                continue
            if nxt in word_count:
                out.append(nxt)
        return out

    for start in sorted(word_count):
        if start in index_of:
            continue
        # iterative Tarjan
        work = [(start, iter(successors(start)))]
        index_of[start] = lowlink[start] = next_index
        next_index += 1
        stack.append(start)
        on_stack.add(start)
        while work:
            word, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index_of:
                    index_of[nxt] = lowlink[nxt] = next_index
                    next_index += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(successors(nxt))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    lowlink[word] = min(lowlink[word], index_of[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[word])
            if lowlink[word] == index_of[word]:
                last = stack[-1]
                if last == word:
                    stack.pop()
                    on_stack.discard(word)
                else:
                    small = (index_of[last] - index_of[word]) <= 50
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        if small:
                            repeat_words.add(w)
                        if w == word:
                            break
    return repeat_words


def _walk(opt: AssemblerOptions, seed: str, word_length: int,
          word_count: dict, word_reads: dict, repeat_words: set,
          unused_words: set) -> tuple[AssembledContig, bool]:
    """Greedy bidirectional extension
    (reference: IterativeAssembler.cpp:149-501)."""
    contig = AssembledContig()
    contig.support_reads = set(word_reads[seed])
    contig.seq = seed
    unused_words.discard(seed)

    if seed in repeat_words:
        contig.conservative_beg = 0
        contig.conservative_end = word_length
        return contig, True

    words_in_contig = {seed}

    # rejecting reads from unselected seed branches
    tmp_trunk = seed[:word_length - 1]
    for symbol in opt.alphabet:
        if symbol == seed[word_length - 1]:
            continue
        new_key = tmp_trunk + symbol
        if new_key in word_reads:
            contig.reject_reads |= word_reads[new_key]

    is_repeat_found = False
    cons_end_offset_right = 0
    cons_end_offset_left = 0

    for mode in range(2):
        is_end = mode == 0
        cons_end_offset = 0
        while True:
            if is_end:
                previous_word = contig.seq[-word_length:]
                trunk = contig.seq[-(word_length - 1):]
            else:
                previous_word = contig.seq[:word_length]
                trunk = contig.seq[:word_length - 1]

            max_base_count = 0
            max_contig_word_read_count = 0
            max_base = opt.alphabet[0]
            max_word = ""
            max_word_reads: set[int] = set()
            max_contig_word_reads: set[int] = set()
            support_remove: set[int] = set()
            reject_add: set[int] = set()
            previous_word_reads: set[int] = set()

            for symbol in opt.alphabet:
                new_key = (trunk + symbol) if is_end else (symbol + trunk)
                if new_key not in word_count:
                    continue
                curr_word_count = word_count[new_key]
                if new_key not in word_reads:
                    continue
                curr_word_reads = word_reads[new_key]
                contig_word_reads = contig.support_reads & curr_word_reads
                shared_reads = max_contig_word_reads & curr_word_reads
                if not contig_word_reads:
                    continue
                if len(contig_word_reads) > max_contig_word_read_count:
                    if max_contig_word_reads:
                        support_remove |= max_contig_word_reads - shared_reads
                    if max_word_reads:
                        reject_add |= max_word_reads - shared_reads
                    max_word_reads = curr_word_reads
                    max_contig_word_read_count = len(contig_word_reads)
                    max_contig_word_reads = contig_word_reads
                    max_base_count = curr_word_count
                    max_base = symbol
                    max_word = new_key
                else:
                    support_remove |= contig_word_reads - shared_reads
                    reject_add |= curr_word_reads - shared_reads

            if max_base_count < opt.min_coverage:
                break
            if max_word in words_in_contig:
                is_repeat_found = True
                break

            contig.seq = (contig.seq + max_base) if is_end \
                else (max_base + contig.seq)

            if cons_end_offset != 0 or \
                    max_base_count < opt.min_conservative_coverage:
                cons_end_offset += 1

            # branch-point backward check
            if max_word_reads != previous_word_reads:
                tmp_symbol = previous_word[0] if is_end \
                    else previous_word[word_length - 1]
                for symbol in opt.alphabet:
                    if symbol == tmp_symbol:
                        continue
                    back_key = (symbol + trunk) if is_end else (trunk + symbol)
                    if back_key == max_word:
                        continue
                    if back_key not in word_reads:
                        continue
                    back_reads = word_reads[back_key]
                    shared = max_contig_word_reads & back_reads
                    to_update = back_reads - shared
                    if to_update:
                        reject_add |= to_update
                        support_remove |= to_update
            previous_word_reads = max_word_reads

            contig.reject_reads |= reject_add
            for rd in max_word_reads:
                if rd not in contig.reject_reads:
                    contig.support_reads.add(rd)
            contig.support_reads -= support_remove

            unused_words.discard(max_word)
            words_in_contig.add(max_word)

        if mode == 0:
            cons_end_offset_right = cons_end_offset
        else:
            cons_end_offset_left = cons_end_offset

    contig.conservative_beg = cons_end_offset_left
    contig.conservative_end = len(contig.seq) - cons_end_offset_right
    return contig, is_repeat_found


def _build_contigs(opt: AssemblerOptions, reads: list[str],
                   read_info: list[AssemblyReadInfo], word_length: int):
    word_count, word_reads = _get_kmer_maps(opt, reads, read_info, word_length)
    repeat_words = _get_repeat_kmers(opt, word_count)
    unused_words = {w for w, c in word_count.items() if c >= opt.min_coverage}

    contigs: list[AssembledContig] = []
    is_success = True
    while unused_words and len(contigs) < 2 * opt.max_assembly_count:
        max_word = ""
        max_word_count = 0
        for word in sorted(unused_words):
            if word_count[word] > max_word_count:
                max_word = word
                max_word_count = word_count[word]
        contig, is_repeat = _walk(opt, max_word, word_length, word_count,
                                  word_reads, repeat_words, unused_words)
        if is_repeat:
            is_success = False
        contigs.append(contig)
    return contigs, is_success


def _select_contigs(opt: AssemblerOptions, read_info: list[AssemblyReadInfo],
                    normal_read_count: int,
                    candidates: list[AssembledContig]) -> list[AssembledContig]:
    """(reference: IterativeAssembler.cpp:722-842)."""
    final: list[AssembledContig] = []
    used_reads: set[int] = set()
    used_pseudo: set[int] = set()
    candidates = list(candidates)

    while candidates and len(final) < opt.max_assembly_count:
        used_normal = len(used_reads) - len(used_pseudo)
        unused_normal = normal_read_count - used_normal
        if unused_normal < opt.min_unused_reads:
            return final
        to_remove: set[int] = set()
        selected = None
        selected_index = -1
        max_support = 0
        max_length = 0
        for ci, contig in enumerate(candidates):
            new_support = contig.support_reads - used_reads
            # an index beyond read_info is a pseudo read erased by a
            # later iteration's rollover (only pseudo reads are erased;
            # the reference indexes readInfo out of bounds here,
            # IterativeAssembler.cpp:776-778)
            new_normal = sum(1 for rd in new_support
                             if rd < len(read_info)
                             and not read_info[rd].is_pseudo)
            if new_normal < opt.min_support_reads:
                to_remove.add(ci)
                continue
            if (len(new_support) > max_support) or \
                    (len(new_support) == max_support
                     and len(contig.seq) > max_length):
                selected = contig
                selected_index = ci
                max_support = len(new_support)
                max_length = len(contig.seq)
        if max_support == 0:
            break
        final.append(selected)
        to_remove.add(selected_index)
        for ci in sorted(to_remove, reverse=True):
            candidates.pop(ci)
        for rd in selected.support_reads:
            used_reads.add(rd)
            if rd >= len(read_info):  # stale (erased pseudo) index
                used_pseudo.add(rd)
                continue
            rinfo = read_info[rd]
            rinfo.is_used = True
            rinfo.contig_ids.append(len(final) - 1)
            if rinfo.is_pseudo:
                used_pseudo.add(rd)
    return final


def _run_native_assembler(opt: AssemblerOptions, reads: list[str]):
    """Native mt_assemble path: identical algorithm in C++ (bitset read
    sets); reconstructs contigs and read_info from the flat result."""
    import ctypes

    import numpy as np

    from .._native import MtAsmResult, get_lib, i64p, u8p
    lib = get_lib()
    blob = "".join(reads).encode()
    off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=off[1:])
    barr = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    out = ctypes.POINTER(MtAsmResult)()
    rc = lib.mt_assemble(
        len(reads), off.ctypes.data_as(i64p), barr.ctypes.data_as(u8p),
        opt.min_word_length, opt.max_word_length, opt.word_step_size,
        opt.min_coverage, opt.min_conservative_coverage,
        opt.min_unused_reads, opt.min_support_reads,
        opt.max_assembly_count, ctypes.byref(out))
    assert rc == 0, f"mt_assemble failed: {rc}"
    try:
        r = out.contents
        n = int(r.n_contigs)
        final_count = int(r.final_read_count)
        pseudo_start = int(r.pseudo_start)
        read_info = [AssemblyReadInfo() for _ in range(final_count)]
        for ri in range(pseudo_start, final_count):
            read_info[ri].is_pseudo = True
        contigs = []
        for t in range(n):
            s0, s1 = r.seq_off[t], r.seq_off[t + 1]
            seq = bytes(bytearray(r.seq_blob[s0:s1])).decode()
            p0, p1 = r.sup_off[t], r.sup_off[t + 1]
            sup = [int(r.sup_idx[k]) for k in range(p0, p1)]
            contigs.append(AssembledContig(
                seq=seq, support_reads=set(sup),
                conservative_beg=int(r.cons_beg[t]),
                conservative_end=int(r.cons_end[t])))
            for rd in sup:
                if rd >= final_count:  # stale (erased pseudo) index
                    continue
                read_info[rd].is_used = True
                read_info[rd].contig_ids.append(t)
        return contigs, read_info
    finally:
        lib.mt_assemble_free(out)


def refine_conservative_ranges(contigs, reads, min_cov: int):
    """Widen each contig's conservative range to the largest contig
    interval whose TRUE per-position supporting-read coverage is
    >= min_cov.

    The walk estimator (reference: IterativeAssembler.cpp:368-369 and
    the Python/native walks here) is sticky: once one extension step
    dips below minConservativeCoverage the offset grows for the REST of
    the walk, so a single thin step early in a walk marks everything
    beyond it non-conservative even where coverage recovers to 10x+.
    Measured on a 2.3 kb insertion's right-flank contig (round 5): walk
    estimate 41 bp vs true >=2x span of 165 bp — the difference decides
    large-insertion candidacy (the sole consumer of this range,
    SVCandidateAssemblyRefiner.cpp:2091). Supporting reads are placed
    by exact match, else by a 25-mer prefix/suffix seed (reads carry
    sequencing errors); unplaceable reads count nothing, and the range
    only ever WIDENS beyond the walk estimate, so noisy data degrades
    to reference behavior."""
    seed = 25
    for c in contigs:
        n = len(c.seq)
        if n == 0 or not c.support_reads:
            continue
        cov = [0] * (n + 1)
        placed = False
        for ri in c.support_reads:
            if ri >= len(reads):
                continue
            r = reads[ri]
            ln = len(r)
            p = c.seq.find(r)
            if p < 0 and ln >= seed:
                q = c.seq.find(r[:seed])
                p = q if q >= 0 else -1
                if p < 0:
                    q = c.seq.find(r[-seed:])
                    if q >= 0:
                        p = q + seed - ln
            if p < 0:
                continue
            lo, hi = max(0, p), min(n, p + ln)
            if hi > lo:
                cov[lo] += 1
                cov[hi] -= 1
                placed = True
        if not placed:
            continue
        run = 0
        ok = [False] * n
        for j in range(n):
            run += cov[j]
            ok[j] = run >= min_cov
        # largest True run
        best_len, best_s = 0, 0
        s = None
        for j in range(n + 1):
            v = ok[j] if j < n else False
            if v and s is None:
                s = j
            elif not v and s is not None:
                if j - s > best_len:
                    best_len, best_s = j - s, s
                s = None
        if best_len > (c.conservative_end - c.conservative_beg):
            c.conservative_beg = best_s
            c.conservative_end = best_s + best_len


def run_iterative_assembler(opt: AssemblerOptions, reads: list[str]):
    """Assemble reads; returns (contigs, read_info). `reads` may be
    extended with pseudo reads during iteration (as in the reference).

    Routes to the native core (mt_assemble) unless
    MANTA_TPU_PY_ASSEMBLER=1 or a non-default alphabet is configured;
    the Python implementation below is the behavioral source of truth
    and the native port is held to it by tests/test_assembler_native.py.
    """
    import os
    if opt.alphabet == "ACGT" and \
            os.environ.get("MANTA_TPU_PY_ASSEMBLER") != "1":
        out = _run_native_assembler(opt, reads)
    else:
        out = _run_python_assembler(opt, reads)
    refine_conservative_ranges(out[0], reads,
                               opt.min_conservative_coverage)
    return out


def _run_python_assembler(opt: AssemblerOptions, reads: list[str]):
    normal_read_count = len(reads)
    read_info = [AssemblyReadInfo() for _ in reads]
    iterative_contigs: list[AssembledContig] = []

    word_length = opt.min_word_length
    while word_length <= opt.max_word_length:
        iterative_contigs, is_success = _build_contigs(
            opt, reads, read_info, word_length)
        if is_success:
            break
        # remove pseudo reads from the previous iteration
        for read_index in range(len(reads)):
            if read_info[read_index].is_pseudo:
                del reads[read_index:]
                del read_info[read_index:]
                break
        # add long-enough contigs as pseudo reads
        for contig in iterative_contigs:
            if len(contig.seq) > word_length + opt.word_step_size:
                reads.append(contig.seq)
                info = AssemblyReadInfo()
                info.is_pseudo = True
                read_info.append(info)
        word_length += opt.word_step_size

    contigs = _select_contigs(opt, read_info, normal_read_count,
                              iterative_contigs)
    return contigs, read_info
