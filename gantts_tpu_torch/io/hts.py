"""HTS full-context label files and Merlin-style question sets: the port's
own copy of gantts_tpu/io/hts.py, held equal to it by
tests/test_torch_tts_io.py.

Re-provision of the ``nnmnkwii.io.hts`` surface the reference uses
(SURVEY.md section 2.3): ``load``, ``load_question_set``, and the
``HTSLabelFile`` methods ``silence_frame_indices``, ``silence_phone_indices``,
``num_frames``, ``set_durations`` (prepare_features_tts.py:56-65,
evaluation_tts.py:145-177).

Formats (public HTS/Merlin conventions):
  * label line: ``<start> <end> <context>`` with times in 100 ns units;
    state-aligned labels append a state marker ``[k]`` (k = 2..6 for the
    usual 5-state HMM topology) and repeat the context per state.
  * question file: ``QS "name" {pat1,pat2,...}`` binary wildcard questions
    (``*`` wildcards, match anywhere) and ``CQS "name" {regex}`` continuous
    questions whose single capture group extracts a number.
"""

from __future__ import annotations

import re

import numpy as np

FRAME_SHIFT_100NS = 50000  # 5 ms in 100 ns units (HTS convention)


class HTSLabelFile:
    """Parsed HTS label: start/end times (100 ns), context strings, state ids.

    ``self.start_times``/``end_times``: int lists; ``contexts``: full-context
    strings; ``state_ids``: 2..6 for state-aligned labels, None otherwise.
    """

    def __init__(self):
        self.start_times = []
        self.end_times = []
        self.contexts = []
        self.state_ids = []
        self.frame_shift = FRAME_SHIFT_100NS

    # -- construction -----------------------------------------------------
    @classmethod
    def from_lines(cls, lines):
        self = cls()
        state_re = re.compile(r"^(.*)\[(\d+)\]$")
        for line in lines:
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 2)
            if len(parts) == 3:
                start, end, ctx = int(parts[0]), int(parts[1]), parts[2]
            elif len(parts) == 1:
                start, end, ctx = -1, -1, parts[0]
            else:
                raise ValueError(f"Malformed HTS label line: {line!r}")
            m = state_re.match(ctx)
            if m:
                ctx, state = m.group(1).strip(), int(m.group(2))
            else:
                state = None
            self.start_times.append(start)
            self.end_times.append(end)
            self.contexts.append(ctx)
            self.state_ids.append(state)
        return self

    def __len__(self):
        return len(self.contexts)

    @property
    def is_state_alignment(self):
        return len(self) > 0 and self.state_ids[0] is not None

    @property
    def num_states(self):
        """States per phone (5 for the usual [2]..[6] topology)."""
        if not self.is_state_alignment:
            return 1
        return max(self.state_ids) - min(self.state_ids) + 1

    # -- phone-level view ---------------------------------------------------
    def phone_boundaries(self):
        """List of (first_line_idx, last_line_idx+1) per phone."""
        if not self.is_state_alignment:
            return [(i, i + 1) for i in range(len(self))]
        bounds = []
        i = 0
        min_state = min(self.state_ids)
        while i < len(self):
            j = i
            while j < len(self) and not (
                    j > i and self.state_ids[j] == min_state):
                j += 1
            bounds.append((i, j))
            i = j
        return bounds

    def phone_contexts(self):
        return [self.contexts[s] for s, _ in self.phone_boundaries()]

    # -- frame arithmetic ---------------------------------------------------
    def num_frames(self):
        return int(self.end_times[-1] / self.frame_shift)

    def frame_counts(self):
        """Frames per label line."""
        return [int((e - s) / self.frame_shift)
                for s, e in zip(self.start_times, self.end_times)]

    def silence_phone_indices(self, regex=r"\-(sil|pau)\+"):
        pat = re.compile(regex)
        return np.array([
            k for k, ctx in enumerate(self.phone_contexts())
            if pat.search(ctx)], dtype=int)

    def silence_frame_indices(self, regex=r"\-(sil|pau)\+"):
        pat = re.compile(regex)
        idx = []
        for (s_line, e_line) in self.phone_boundaries():
            if pat.search(self.contexts[s_line]):
                f0 = int(self.start_times[s_line] / self.frame_shift)
                f1 = int(self.end_times[e_line - 1] / self.frame_shift)
                idx.extend(range(f0, f1))
        return np.array(idx, dtype=int)

    def set_durations(self, durations, frame_shift=FRAME_SHIFT_100NS):
        """Rewrite start/end times from predicted per-line durations (frames).

        Contract of evaluation_tts.py:177: ``durations`` is (num_lines, 1) or
        (num_lines,) for state alignment (one row per state line).
        """
        durations = np.asarray(durations).reshape(-1)
        if len(durations) != len(self):
            raise ValueError(
                f"{len(durations)} durations for {len(self)} label lines")
        t = 0
        for i, d in enumerate(durations):
            self.start_times[i] = t
            t += int(round(float(d))) * frame_shift
            self.end_times[i] = t

    def save(self, path):
        with open(path, "w") as f:
            for s, e, ctx, st in zip(self.start_times, self.end_times,
                                     self.contexts, self.state_ids):
                suffix = f"[{st}]" if st is not None else ""
                f.write(f"{s} {e} {ctx}{suffix}\n")


def load(path):
    """Load an HTS label file (prepare_features_tts.py:56 contract)."""
    with open(path) as f:
        return HTSLabelFile.from_lines(f.readlines())


def _wildcard_to_regex(pattern):
    """HTS question wildcard -> regex fragment.

    ``*`` matches anything; the pattern must match somewhere in the context
    string; all other characters are literal.
    """
    out = []
    for ch in pattern:
        if ch == "*":
            out.append(".*")
        elif ch == "?":
            out.append(".")
        else:
            out.append(re.escape(ch))
    body = "".join(out)
    if not pattern.startswith("*"):
        body = "(?:^|(?<=/))" + body  # anchor at start or a field boundary
    return body


def load_question_set(path):
    """Parse a Merlin .hed question file.

    Returns (binary_dict, continuous_dict): ordered dicts index -> (name,
    compiled regex list / compiled capture regex) — feature order follows
    file order, binary questions first, then continuous (the Merlin
    convention the reference's 416-question set relies on,
    hparams.py:94-95)."""
    binary_dict, continuous_dict = {}, {}
    qs_re = re.compile(r'^\s*QS\s+"([^"]+)"\s*\{([^}]+)\}')
    cqs_re = re.compile(r'^\s*CQS\s+"([^"]+)"\s*\{([^}]+)\}')
    with open(path) as f:
        for line in f:
            m = qs_re.match(line)
            if m:
                name, pats = m.group(1), m.group(2)
                regs = [re.compile(_wildcard_to_regex(p.strip()))
                        for p in pats.split(",") if p.strip()]
                binary_dict[len(binary_dict)] = (name, regs)
                continue
            m = cqs_re.match(line)
            if m:
                name, pat = m.group(1), m.group(2).strip()
                continuous_dict[len(continuous_dict)] = (
                    name, re.compile(pat))
    return binary_dict, continuous_dict
