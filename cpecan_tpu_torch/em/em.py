"""Baum-Welch EM training of the pair-HMM on PyTorch.

Counterpart of cpecan_tpu/em/em.py (the cPecanEm jobTree pipeline,
cPecanEm.py):

  reference                               -> here
  ---------                               ----
  split cigars into <=maxAlignmentLength  -> same chunking, host-side
    PerJob files (:128-145)
  shuffle-sample to maxAlignmentLength    -> same (:147-158)
    ToSample
  scatter `cat chunk | cPecanRealign      -> chunks sharded over the
    --outputExpectations` subprocesses       processes (process_shard);
    (:178-180)                               bucketed batches of banded-FB
                                             expectation passes on
                                             ``device`` (the CUDA kernels
                                             on a GPU) or sharded over a
                                             DataMesh
  gather: sum expectation files (:184-188)-> per-pair counts summed on the
                                             device, float64 on the host,
                                             then one all-gather sum over
                                             the processes
  normalise / tie / keep emissions        -> identical host math (:188-199)
  model file rewritten per iteration      -> same (iteration-granular
    (:202)                                   checkpoint/resume)
  --updateTheBand realign (:205-215)      -> in-process realign of chunk
                                             cigars with the current model
  --trials random restarts (:217-242)     -> sequential

The expectation passes are the batch layer's ``expectation_step``
(align/batch.py): tasks too long for the two-pass engine run one at a
time through the exact streaming engine (ops/fb_streaming.py), as in
cpecan_tpu.

Several processes (after parallel.mesh.initialize_distributed) each run
the same program on the whole corpus and keep their shard of the chunks;
the counts are summed across the processes, so every process computes
the same model, and only process 0 writes files.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
import xml.etree.ElementTree as ET

import numpy as np

from cpecan_tpu_torch.align.batch import alignment_tasks, expectation_step
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.hmm import Hmm, StateMachineType
from cpecan_tpu_torch.models.state_machine import (
    default_state_machine, state_machine_from_hmm)
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.parallel.mesh import (
    all_sum_across_processes, process_count, process_index, process_shard)
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.retry import run_with_retries


@dataclasses.dataclass
class EmOptions:
    """Mirror of cPecanEm's Options (cPecanEm.py:361-380)."""
    modelType: str = "fiveState"
    inputModel: str | None = None
    iterations: int = 10
    trials: int = 3
    outputTrialHmms: bool = False
    randomStart: bool = False
    updateTheBand: bool = False
    maxAlignmentLengthPerJob: int = 1_000_000
    maxAlignmentLengthToSample: int = 50_000_000
    useDefaultModelAsStart: bool = False
    setJukesCantorStartingEmissions: float | None = None
    tieEmissions: bool = False
    trainEmissions: bool = False
    outputXMLModelFile: str | None = None
    blastScoringMatrixFile: str | None = None
    # realign parameters used for the expectation passes (the reference's
    # optionsToRealign default: --diagonalExpansion=10
    # --splitMatrixBiggerThanThis=3000, cPecanEm.py:371)
    diagonalExpansion: int = 10
    splitMatrixBiggerThanThis: int = 3000 * 3000
    constraintDiagonalTrim: int = 0
    seed: int = 0
    # transient-failure retries per expectation chunk (the jobTree
    # retryCount analog; jobTree re-ran failed Targets, cPecanEm.py:423)
    retryCount: int = 1

    def model_type(self) -> StateMachineType:
        return StateMachineType[self.modelType]

    def pairwise_params(self) -> PairwiseAlignmentParameters:
        return PairwiseAlignmentParameters(
            constraintDiagonalTrim=self.constraintDiagonalTrim,
            diagonalExpansion=self.diagonalExpansion,
            splitMatrixBiggerThanThis=self.splitMatrixBiggerThanThis)


# ---------------------------------------------------------------- chunking

def split_alignments(cigars, max_alignment_length_per_job: float) -> list:
    """Split the cigar corpus into chunks of bounded total alignment length
    (avg of the two spans; cPecanEm.py:128-145)."""
    chunks, current, length = [], [], 0.0
    for pa in cigars:
        current.append(pa)
        length += (abs(pa.start1 - pa.end1) + abs(pa.start2 - pa.end2)) / 2.0
        if length > max_alignment_length_per_job:
            chunks.append((current, length))
            current, length = [], 0.0
    if current:
        chunks.append((current, length))
    return chunks


def sample_chunks(chunks: list, max_total: float, rng: random.Random) -> list:
    """Shuffle-sample chunks up to max_total bases (cPecanEm.py:147-158)."""
    chunks = list(chunks)
    rng.shuffle(chunks)
    out, total = [], 0.0
    for chunk, length in chunks:
        out.append(chunk)
        total += length
        if total >= max_total:
            break
    return out


# ------------------------------------------------------------ expectations

def tasks_from_cigars(cigars, sequences: dict,
                      p: PairwiseAlignmentParameters) -> list:
    """Alignments -> banded sub-problems, via the cPecanRealign
    expectation path: subsequences (rev-comp for minus strands), anchors
    from cigar match runs filtered to exact base matches, ragged 1,1,
    large-gap splitting (cPecanRealign.c:516-534), built over the whole
    job at once (align/batch.alignment_tasks)."""
    return alignment_tasks(cigars, sequences, p)


# ----------------------------------------------------------------- EM loop

def maximisation_step(expectations: Hmm, old_model: Hmm | None,
                      options: EmOptions) -> Hmm:
    """Normalise counts into the new model; optionally tie emissions or keep
    the previous model's emissions (cPecanEm.py:182-202)."""
    expectations.normalise()
    if options.trainEmissions:
        if options.tieEmissions:
            expectations.tie_emissions()
    elif old_model is not None:
        expectations.emissions = old_model.emissions.copy()
    return expectations


def make_initial_model(options: EmOptions, rng: random.Random) -> Hmm:
    """cPecanEm.py:109-123."""
    if options.inputModel is not None:
        hmm = Hmm.load(options.inputModel)
        hmm.normalise()
    else:
        hmm = Hmm(options.model_type())
        if options.randomStart:
            hmm.randomise(np.random.default_rng(rng.randrange(1 << 30)))
        else:
            hmm.equalise()
    if options.setJukesCantorStartingEmissions is not None:
        hmm.set_emissions_to_jukes_cantor(options.setJukesCantorStartingEmissions)
    return hmm


def realign_chunk(chunk, sequences, model_file=None, extra_args=None,
                  model: Hmm | None = None, device="cuda"):
    """Band update: realign a chunk's cigars with the current model
    (cPecanEm.py calculateAlignments :212-215). Pass either a model file
    path or an in-memory Hmm (written to a private temp file)."""
    import io as _io
    import tempfile

    from cpecan_tpu_torch.cli import realign as realign_cli

    buf_in = _io.StringIO("".join(cigar_io.cigar_format(pa) + "\n" for pa in chunk))
    buf_out = _io.StringIO()
    tmpdir = tempfile.mkdtemp(prefix="cpecan_band_update_")
    if model is not None:
        model_file = os.path.join(tmpdir, "model.hmm")
        model.save(model_file, precise=True)
    seq_file = os.path.join(tmpdir, "seqs.fa")
    with open(seq_file, "w") as fh:
        for name, seq in sequences.items():
            fh.write(f">{name}\n{seq}\n")
    argv = [seq_file, "--loadHmm", model_file,
            "--diagonalExpansion", "10", "--splitMatrixBiggerThanThis", "3000",
            "--device", str(device)]
    if extra_args:
        argv += extra_args
    realign_cli.main(argv, stdin=buf_in, stdout=buf_out)
    for name in os.listdir(tmpdir):
        os.unlink(os.path.join(tmpdir, name))
    os.rmdir(tmpdir)
    buf_out.seek(0)
    return list(cigar_io.cigar_read(buf_out))


def expectation_maximisation(sequences: dict, cigars: list, output_model: str,
                             options: EmOptions, mesh=None,
                             device="cuda") -> Hmm:
    """One full EM run (cPecanEm.py expectationMaximisation :107-215).
    Writes the model file after every iteration — the checkpoint/resume
    granularity of the reference pipeline.

    Multi-process (after parallel.mesh.initialize_distributed): every
    process runs this same function on the full corpus; chunks are
    sharded by process (the jobTree scatter analog), the per-process
    counts are summed across the processes (the pipeline's only
    collective, which a process without chunks joins too), and the
    maximisation runs identically everywhere, so the in-memory model
    never diverges. Only process 0 touches the model file."""
    rng = random.Random(options.seed)
    current = make_initial_model(options, rng)
    is_writer = process_index() == 0
    if is_writer:
        current.save(output_model, precise=True)

    with metrics.stage("em_split"):
        chunks = split_alignments(cigars, options.maxAlignmentLengthPerJob)
        chunks = sample_chunks(chunks, options.maxAlignmentLengthToSample,
                               rng)
    local_chunks = process_shard(chunks)

    p = options.pairwise_params()
    running = []
    for iteration in range(options.iterations):
        use_default = options.useDefaultModelAsStart and iteration == 0
        if use_default:
            sm = default_state_machine(options.model_type())
        else:
            sm = state_machine_from_hmm(current)
        pseudo = 1e-12
        expectations = Hmm(options.model_type(), pseudo_expectation=pseudo)
        for chunk in local_chunks:
            # one chunk = one retry unit (the jobTree Target analog:
            # cPecanEm's calculateExpectations jobs were re-run by jobTree
            # up to retryCount on failure, cPecanEm.py:423-426). Counts go
            # into a scratch container so a mid-chunk failure never
            # double-accumulates.
            def one_chunk():
                scratch = Hmm(options.model_type())
                with metrics.stage("em_tasks"):
                    tasks = tasks_from_cigars(chunk, sequences, p)
                expectation_step(sm, tasks, p, scratch, mesh=mesh,
                                 device=device)
                return scratch
            scratch = run_with_retries(one_chunk, "expectation chunk",
                                       attempts=options.retryCount + 1)
            expectations.transitions += scratch.transitions
            expectations.emissions += scratch.emissions
            expectations.likelihood += scratch.likelihood
        if process_count() > 1:
            trans, emis, like = all_sum_across_processes(
                [expectations.transitions, expectations.emissions,
                 np.asarray([expectations.likelihood])])
            # pseudocounts were summed once per process; deduplicate
            extra = (process_count() - 1) * pseudo
            expectations.transitions = trans - extra
            expectations.emissions = emis - extra
            expectations.likelihood = float(like[0])
        with metrics.stage("em_mstep"):
            new_model = maximisation_step(expectations, current, options)
            running.append(new_model.likelihood)
            current = new_model
            if is_writer:
                new_model.save(output_model, precise=True)
        if options.updateTheBand:
            band_device = device if mesh is None else mesh.devices[0]
            local_chunks = [realign_chunk(c, sequences, model=current,
                                          device=band_device)
                            for c in local_chunks]

    current.running_likelihoods = running
    if is_writer:
        current.save(output_model, precise=True)
    return current


def expectation_maximisation_trials(sequences: dict, cigars: list,
                                    output_model: str, options: EmOptions,
                                    mesh=None, device="cuda") -> Hmm:
    """Random-restart trials, keeping the max-likelihood model
    (cPecanEm.py:217-242). File outputs happen on process 0 only."""
    is_writer = process_index() == 0
    if options.inputModel is not None or not options.randomStart:
        hmm = expectation_maximisation(sequences, cigars, output_model,
                                       options, mesh=mesh, device=device)
        trial_hmms = [hmm]
    else:
        trial_hmms = []
        for trial in range(options.trials):
            trial_options = dataclasses.replace(options, seed=options.seed + trial)
            trial_file = f"{output_model}_trial{trial}"
            trial_hmms.append(expectation_maximisation(
                sequences, cigars, trial_file, trial_options, mesh=mesh,
                device=device))
            if options.outputTrialHmms and is_writer:
                trial_hmms[-1].save(output_model + f"_{trial}", precise=True)
        best = max(trial_hmms, key=lambda h: h.likelihood)
        if is_writer:
            best.save(output_model, precise=True)
            for trial in range(options.trials):
                trial_file = f"{output_model}_trial{trial}"
                if os.path.exists(trial_file):
                    os.unlink(trial_file)
        hmm = best

    if options.outputXMLModelFile and is_writer:
        with open(options.outputXMLModelFile, "w") as fh:
            fh.write(ET.tostring(hmms_xml(trial_hmms), encoding="unicode"))
    if options.blastScoringMatrixFile and is_writer:
        seqs = list(sequences.values())
        match_probs, gap_open, gap_extend = make_blast_scoring_matrix(hmm, seqs)
        with open(options.blastScoringMatrixFile, "w") as fh:
            write_lastz_scoring_matrix(fh, match_probs, gap_open, gap_extend)
    return hmm


# --------------------------------------------------------------- reporting

def hmms_xml(hmms: list) -> ET.Element:
    """XML stats summary over trials (cPecanEm.py hmmsXML :244-299)."""
    if not hmms:
        raise RuntimeError("No hmms to summarise")
    state_number = hmms[0].state_number
    model_type = hmms[0].type.name
    for h in hmms[1:]:
        if h.type.name != model_type or h.state_number != state_number:
            raise RuntimeError("Hmms not all of the same type")

    parent = ET.Element("hmms", {"modelType": model_type,
                                 "stateNumber": str(state_number)})
    for h in hmms:
        child = ET.SubElement(parent, "hmm")
        child.attrib["likelihood"] = str(h.likelihood)
        child.attrib["runningLikelihoods"] = "\t".join(map(str, h.running_likelihoods))
        child.attrib["transitions"] = "\t".join(map(str, h.transitions.reshape(-1)))
        child.attrib["emissions"] = "\t".join(map(str, h.emissions.reshape(-1)))

    likelihoods = [h.likelihood for h in hmms]
    parent.attrib["maxLikelihood"] = str(max(likelihoods))
    parent.attrib["likelihoods"] = "\t".join(map(str, likelihoods))
    parent.attrib["likelihoodAvg"] = str(np.average(likelihoods))
    parent.attrib["likelihoodStdDev"] = str(np.std(likelihoods))

    def stat(values, node):
        node.attrib["max"] = str(max(values))
        node.attrib["avg"] = str(np.average(values))
        node.attrib["std"] = str(np.std(values))
        node.attrib["min"] = str(min(values))
        node.attrib["distribution"] = "\t".join(map(str, values))

    for i in range(state_number):
        for j in range(state_number):
            stat([h.transitions[i, j] for h in hmms],
                 ET.SubElement(parent, "transition", {"from": str(i), "to": str(j)}))
    for s in range(state_number):
        for x in range(4):
            for y in range(4):
                stat([h.emissions[s, x, y] for h in hmms],
                     ET.SubElement(parent, "emission",
                                   {"state": str(s), "x": "ACGT"[x], "y": "ACGT"[y]}))
    return parent


def make_blast_scoring_matrix(hmm: Hmm, sequences: list):
    """HMM -> lastz scoring matrix (cPecanEm.py makeBlastScoringMatrix
    :301-338): collapse to 3-state, log-odds match scores vs GC-aware
    background, gap open/extend from the transitions."""
    h3 = Hmm(StateMachineType.threeState)
    h3.transitions = hmm.transitions[:3, :3].copy()
    h3.emissions = hmm.emissions[:3].copy()
    h3.normalise()

    total = sum(len(s) for s in sequences)
    gc = (sum(1 for s in sequences for ch in s if ch in "GCgc") / total
          if total else 0.5)

    def base_prob(x):
        return gc / 2.0 if x in (1, 2) else (1.0 - gc) / 2.0

    match_probs = [h3.emissions[0, x, y] / (base_prob(x) * base_prob(y))
                   for x in range(4) for y in range(4)]
    match_continue = h3.transitions[0, 0]
    # 6.94 is 1/100th the sum of the lastz scoring matrix (reference :322)
    n_prob = math.sqrt(math.exp(
        (6.94 + sum(math.log(x * match_continue) for x in match_probs))
        / len(match_probs)))
    weight = 100
    match_scores = [weight * math.log((x * match_continue) / n_prob ** 2)
                    for x in match_probs]
    gap_open = weight * math.log(
        (0.5 * (h3.transitions[0, 1] / n_prob + h3.transitions[0, 2] / n_prob))
        * ((h3.transitions[1, 0] + h3.transitions[2, 0]) / (2 * n_prob ** 2))
        * ((n_prob ** 2) / match_continue))
    gap_extend = weight * math.log(
        0.5 * (h3.transitions[1, 1] / n_prob + h3.transitions[2, 2] / n_prob))
    return match_scores, gap_open, gap_extend


def write_lastz_scoring_matrix(fh, match_probs, gap_open, gap_extend) -> None:
    """Lastz/Blastz scoring-matrix text (cPecanEm.py :340-359)."""
    fh.write("gap_open_penalty = %s\n" % int(round(-gap_open)))
    fh.write("gap_extend_penalty = %s\n" % int(round(-gap_extend)))
    bases = "ACGT"
    fh.write("\t\t" + "\t".join(bases) + "\n")
    for x in range(4):
        row = "\t".join(str(int(round(v))) for v in match_probs[x * 4 : (x + 1) * 4])
        fh.write("\t%s\t%s\n" % (bases[x], row))
