"""Merlin-style linguistic feature extraction from HTS labels: the port's
own copy of gantts_tpu/io/merlin.py, held equal to it by
tests/test_torch_tts_io.py.

Re-provision of ``nnmnkwii.frontend.merlin`` as exercised by the reference:
``linguistic_features`` with phone-level (duration model,
add_frame_features=False, subphone_features=None) and frame-level
(acoustic model, add_frame_features=True, subphone_features="full") modes
(prepare_features_tts.py:57-60, evaluation_tts.py:146-151, 199-204), and
``duration_features`` (prepare_features_tts.py:86).

Feature layout:
  [binary questions (file order) | continuous questions (file order)
   | 9 subphone features when subphone_features == "full"]

The 9 "full" subphone features (frame-level, state alignment), in order:
  1. forward fraction through the state     (i+1)/state_frames
  2. backward fraction through the state    (state_frames-i)/state_frames
  3. state duration in frames
  4. state index, forward (1-based)
  5. state index, backward
  6. phone duration in frames
  7. backward fraction through the phone
  8. forward fraction through the phone
  9. state/phone duration ratio
(dimensionally matching Merlin's 9 "full" features; with the reference's
416-question set this yields the 425-dim acoustic input, hparams.py:94+
train.py:753-757.)
"""

from __future__ import annotations

import numpy as np


def _answer_questions(context, binary_dict, continuous_dict):
    n_bin, n_cont = len(binary_dict), len(continuous_dict)
    row = np.zeros(n_bin + n_cont, dtype=np.float32)
    for i in range(n_bin):
        _, regs = binary_dict[i]
        row[i] = 1.0 if any(r.search(context) for r in regs) else 0.0
    for i in range(n_cont):
        _, reg = continuous_dict[i]
        m = reg.search(context)
        if m:
            try:
                row[n_bin + i] = float(m.group(1))
            except (IndexError, ValueError):
                row[n_bin + i] = -1.0
        else:
            row[n_bin + i] = -1.0
    return row


def linguistic_features(labels, binary_dict, continuous_dict,
                        add_frame_features=False, subphone_features=None,
                        frame_shift=50000):
    """HTS labels -> linguistic feature matrix.

    Phone-level: (n_phones, n_questions).  Frame-level with
    subphone_features="full": (n_frames, n_questions + 9)."""
    bounds = labels.phone_boundaries()
    contexts = labels.phone_contexts()
    q = np.stack([_answer_questions(c, binary_dict, continuous_dict)
                  for c in contexts])

    if not add_frame_features:
        return q.astype(np.float32)

    if subphone_features not in (None, "full"):
        raise ValueError(
            f"subphone_features={subphone_features!r} not supported "
            "(None | 'full')")

    rows = []
    frame_counts = labels.frame_counts()
    for p, (s_line, e_line) in enumerate(bounds):
        n_states = e_line - s_line
        state_frames = [frame_counts[k] for k in range(s_line, e_line)]
        phone_frames = int(sum(state_frames))
        if phone_frames == 0:
            continue
        for si, sf in enumerate(state_frames):
            for i in range(sf):
                j = int(sum(state_frames[:si])) + i  # frame index in phone
                if subphone_features == "full":
                    sub = np.array([
                        (i + 1) / sf,
                        (sf - i) / sf,
                        float(sf),
                        float(si + 1),
                        float(n_states - si),
                        float(phone_frames),
                        (phone_frames - j) / phone_frames,
                        (j + 1) / phone_frames,
                        sf / phone_frames,
                    ], dtype=np.float32)
                    rows.append(np.concatenate([q[p], sub]))
                else:
                    rows.append(q[p])
    return np.stack(rows).astype(np.float32)


def duration_features(labels):
    """Per-phone state durations in frames: (n_phones, n_states)
    (prepare_features_tts.py:86 contract; stream_sizes=[5] parity)."""
    bounds = labels.phone_boundaries()
    frame_counts = labels.frame_counts()
    n_states = labels.num_states
    out = np.zeros((len(bounds), n_states), dtype=np.float32)
    for p, (s_line, e_line) in enumerate(bounds):
        for k in range(s_line, e_line):
            out[p, k - s_line] = frame_counts[k]
    return out
