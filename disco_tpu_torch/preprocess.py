"""Read preprocessing: BBTools orchestration (the runECC.sh / runAssembly.sh
preprocessing layer, SURVEY.md L1).  A copy of disco_tpu/preprocess.py,
which imports no jax but lives in the JAX package: change both together
(tests/test_torch_preprocess.py holds their commands and files equal).

The reference drives three bundled BBTools programs per input-shape branch
(reference: runECC.sh:180-440, runAssembly.sh:195-430):

  1. bbduk.sh  — adapter trim:   ktrim=r k=23 mink=7 hdist=1 tpe tbo
                 ref=<bbmap>/resources/adapters.fa ftm=5 qtrim=r trimq=<q>
                 (q=15 for interleaved/single branches runECC.sh:198,219;
                  q=10 for separated-pair and mixed branches runECC.sh:263,325)
  2. bbduk.sh  — artifact/phiX filter: k=23 hdist=1
                 ref=<bbmap>/resources/sequencing_artifacts.fa.gz,
                     <bbmap>/resources/phix174_ill.ref.fa.gz
  3. bbmerge.sh ecco mix adapters=default   (paired branches; overlap-based
                 error correction of read pairs, runECC.sh:212,236,299)
  4. tadpole.sh ecc prealloc prefilter=2 tossjunk  (k-mer error correction,
                 runECC.sh:213,237,300; the P+S mixed branch adds k=31,
                 runECC.sh:337)

BBTools is third-party Java the reference bundles in bbmap/ (~20 MB); we
treat it as an external dependency (point --bbmap at any BBTools install)
and re-implement only the orchestration.  Intermediate naming follows the
reference (trm.<name>, ftl.trm.<name>, tecc.ftl.trm.<name>); the bbmerge
intermediate, which runECC.sh:212 routes through an *unset* shell variable
(a latent reference bug — the command degenerates to `out=`), is named
explicitly here: bbmecc.ftl.trm.<name>.

Intermediates are deleted after preprocessing like the reference's `rm`
lines (runECC.sh:215,239,303) unless keep_intermediates=True.
"""
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

ADAPTER_FLAGS = ["ktrim=r", "k=23", "mink=7", "hdist=1", "tpe", "tbo"]
ADAPTER_TAIL = ["ftm=5", "qtrim=r"]
FILTER_FLAGS = ["k=23", "hdist=1"]
BBMERGE_FLAGS = ["ecco", "mix", "adapters=default"]
TADPOLE_FLAGS = ["ecc", "prealloc", "prefilter=2", "tossjunk"]


class BBToolsNotFound(RuntimeError):
    pass


def _tool(bbmap_dir: str, name: str) -> str:
    path = os.path.join(bbmap_dir, name)
    if not os.path.isfile(path):
        raise BBToolsNotFound(
            f"{name} not found in {bbmap_dir!r}. Point --bbmap at a BBTools "
            "install (the reference bundles one in bbmap/; any upstream "
            "BBTools release works).")
    return path


def _run(cmd: Sequence[str], log: Optional[list]) -> None:
    if log is not None:
        log.append(list(cmd))
    subprocess.run(list(cmd), check=True)


def _extra(threads: Optional[int], mem_gb: Optional[int]) -> List[str]:
    ex = []
    if threads:
        ex.append(f"t={threads}")
    if mem_gb:
        ex.append(f"-Xmx{mem_gb}g")
    return ex


class Preprocessor:
    """One preprocessing run rooted at workdir.

    run() dispatches on input shape exactly like the reference's branch
    ladder (runECC.sh:178-440) and returns (paired_files, single_files)
    ready for buildG (-pe interleaved + -se single)."""

    def __init__(self, bbmap_dir: str, workdir: str = ".",
                 threads: Optional[int] = None, mem_gb: Optional[int] = None,
                 keep_intermediates: bool = False,
                 command_log: Optional[list] = None):
        self.bb = bbmap_dir
        self.workdir = workdir
        self.extra = _extra(threads, mem_gb)
        self.keep = keep_intermediates
        self.log = command_log
        self.adapters = os.path.join(bbmap_dir, "resources", "adapters.fa")
        self.artifacts = ",".join([
            os.path.join(bbmap_dir, "resources",
                         "sequencing_artifacts.fa.gz"),
            os.path.join(bbmap_dir, "resources", "phix174_ill.ref.fa.gz")])
        os.makedirs(workdir, exist_ok=True)

    def _wd(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def _trim_filter(self, path: str, trimq: int) -> Tuple[str, List[str]]:
        """bbduk adapter-trim then artifact-filter one (possibly interleaved)
        file; returns (filtered path, intermediates)."""
        base = os.path.basename(path.strip())
        trm, ftl = self._wd(f"trm.{base}"), self._wd(f"ftl.trm.{base}")
        bbduk = _tool(self.bb, "bbduk.sh")
        _run([bbduk, f"in={path.strip()}", f"out={trm}", *ADAPTER_FLAGS,
              f"ref={self.adapters}", *ADAPTER_TAIL, f"trimq={trimq}",
              *self.extra], self.log)
        _run([bbduk, f"in={trm}", f"out={ftl}", *FILTER_FLAGS,
              f"ref={self.artifacts}", *self.extra], self.log)
        return ftl, [trm, ftl]

    def _trim_filter_pair(self, p1: str, p2: str, interleave: bool,
                          ) -> Tuple[List[str], List[str]]:
        """Separated-pair variant (in/in2, trimq=10, runECC.sh:263-264).
        interleave=True collapses the filter step's output to one interleaved
        file (the mixed 1/2+S branch, runECC.sh:363-364)."""
        b1 = os.path.basename(p1.strip())
        b2 = os.path.basename(p2.strip())
        trm1, trm2 = self._wd(f"trm.{b1}"), self._wd(f"trm.{b2}")
        bbduk = _tool(self.bb, "bbduk.sh")
        _run([bbduk, f"in={p1.strip()}", f"in2={p2.strip()}",
              f"out={trm1}", f"out2={trm2}", *ADAPTER_FLAGS,
              f"ref={self.adapters}", *ADAPTER_TAIL, "trimq=10",
              *self.extra], self.log)
        if interleave:
            ftl = self._wd(f"int.ftl.trm.{b1}")
            _run([bbduk, f"in={trm1}", f"in2={trm2}", f"out={ftl}",
                  *FILTER_FLAGS, f"ref={self.artifacts}", *self.extra],
                 self.log)
            return [ftl], [trm1, trm2, ftl]
        ftl1, ftl2 = self._wd(f"ftl.trm.{b1}"), self._wd(f"ftl.trm.{b2}")
        _run([bbduk, f"in={trm1}", f"in2={trm2}", f"out={ftl1}",
              f"out2={ftl2}", *FILTER_FLAGS, f"ref={self.artifacts}",
              *self.extra], self.log)
        return [ftl1, ftl2], [trm1, trm2, ftl1, ftl2]

    def _ecc_interleaved(self, ftl_files: List[str],
                         tadpole_k: Optional[int] = None,
                         extra_in: Sequence[str] = (),
                         extra_out: Sequence[str] = (),
                         ) -> Tuple[List[str], List[str]]:
        """bbmerge ecco + tadpole ecc over interleaved file lists
        (runECC.sh:212-213).  extra_in/extra_out append single-end files to
        the tadpole call only (the P+S branch, runECC.sh:337)."""
        bbm = [self._wd("bbmecc." + os.path.basename(f)) for f in ftl_files]
        tecc = [self._wd("tecc." + os.path.basename(f)) for f in ftl_files]
        _run([_tool(self.bb, "bbmerge.sh"), f"in={','.join(ftl_files)}",
              f"out={','.join(bbm)}", *BBMERGE_FLAGS, *self.extra], self.log)
        kflag = [f"k={tadpole_k}"] if tadpole_k else []
        _run([_tool(self.bb, "tadpole.sh"),
              f"in={','.join(list(bbm) + list(extra_in))}",
              f"out={','.join(tecc + [self._wd('tecc.' + os.path.basename(f))
                                      for f in extra_out])}",
              *kflag, *TADPOLE_FLAGS, *self.extra], self.log)
        return tecc, bbm

    def _ecc_separated_pairs(self, ftl1: List[str], ftl2: List[str],
                             exts: List[str]) -> Tuple[List[str], List[str]]:
        """Pairs-only error correction (runECC.sh:296-300): ONE bbmerge over
        all R1/R2 filtered lists, ONE tadpole pooling the merged output into
        a shared k-mer spectrum; outputs interleave at the tadpole step and
        are named int.tecc.ftl.trm.<i>.<ext> (extension1="${fName1#*.}",
        runECC.sh:277-278).  The reference routes the bbmerge output through
        unset shell variables (same latent bug as the interleaved branch);
        we name the per-pair interleaved intermediates bbmecc.<i>.<ext>."""
        bbm = [self._wd(f"bbmecc.{i}.{e}") for i, e in enumerate(exts)]
        tecc = [self._wd(f"int.tecc.ftl.trm.{i}.{e}")
                for i, e in enumerate(exts)]
        _run([_tool(self.bb, "bbmerge.sh"), f"in={','.join(ftl1)}",
              f"in2={','.join(ftl2)}", f"out={','.join(bbm)}",
              *BBMERGE_FLAGS, *self.extra], self.log)
        _run([_tool(self.bb, "tadpole.sh"), f"in={','.join(bbm)}",
              f"out={','.join(tecc)}", *TADPOLE_FLAGS, *self.extra],
             self.log)
        return tecc, bbm

    def _rm(self, files: Sequence[str]) -> None:
        for f in files:
            try:
                os.remove(f)
            except OSError:
                pass

    def run(self, in1: Sequence[str] = (), in2: Sequence[str] = (),
            inP: Sequence[str] = (), inS: Sequence[str] = (),
            ) -> Tuple[List[str], List[str]]:
        in1, in2 = list(in1), list(in2)
        inP, inS = list(inP), list(inS)
        if bool(in1) != bool(in2) or (in1 and len(in1) != len(in2)):
            raise ValueError("-in1/-in2 must be equal-length lists")
        if not (in1 or inP or inS):
            raise ValueError("no input files")
        if in1 and inP:
            # reference: "Invalid combination of input files. You can
            # specify either a set of comma separated interleaved paired
            # file or two separate paired files not both." (runECC.sh's
            # final else branch, exit 1)
            raise ValueError("cannot combine -in1/-in2 with -inP")
        paired: List[str] = []
        single: List[str] = []
        junk: List[str] = []

        if inP and not (in1 or inS):                 # interleaved only
            ftl = []
            for f in inP:
                p, j = self._trim_filter(f, trimq=15)
                ftl.append(p)
                junk += j
            tecc, bbm = self._ecc_interleaved(ftl)
            paired, junk = tecc, junk + bbm
        elif inS and not (in1 or inP):               # single-end only
            ftl = []
            for f in inS:
                p, j = self._trim_filter(f, trimq=15)
                ftl.append(p)
                junk += j
            tecc, bbm = self._ecc_interleaved(ftl)
            single, junk = tecc, junk + bbm
        elif in1 and not inS:                        # separated pairs only
            # R1/R2 stay separate through trim+filter; ONE bbmerge over all
            # pairs + ONE tadpole interleave at the ecc step
            # (runECC.sh:263-300)
            ftl1, ftl2, exts = [], [], []
            for p1, p2 in zip(in1, in2):
                fl, j = self._trim_filter_pair(p1, p2, interleave=False)
                ftl1.append(fl[0])
                ftl2.append(fl[1])
                junk += j
                b1 = os.path.basename(p1.strip())
                exts.append(b1.split(".", 1)[1] if "." in b1 else b1)
            tecc, bbm = self._ecc_separated_pairs(ftl1, ftl2, exts)
            paired, junk = tecc, junk + bbm
        elif inP and inS and not in1:                # interleaved + single
            ftlS, ftlP = [], []
            for f in inS:
                p, j = self._trim_filter(f, trimq=10)
                ftlS.append(p)
                junk += j
            for f in inP:
                p, j = self._trim_filter(f, trimq=10)
                ftlP.append(p)
                junk += j
            tecc, bbm = self._ecc_interleaved(ftlP, tadpole_k=31,
                                              extra_in=ftlS, extra_out=ftlS)
            paired = tecc
            single = [self._wd("tecc." + os.path.basename(f)) for f in ftlS]
            junk += bbm
        else:                                        # separated pairs + single
            # pairs interleave at the FILTER step (int.ftl.trm.<r1>); ONE
            # bbmerge over all interleaved pair files, ONE tadpole with
            # ecc k=31 pooling pairs AND singles into a shared k-mer
            # spectrum (the reference's P1/P2+SE branch: per-pair bbduk
            # in/in2 -> out=int.ftl.trm, then single bbmerge + tadpole
            # in=<merged>,<singles> out=<pairs>,<singles> ecc k=31)
            ftlP = []
            for p1, p2 in zip(in1, in2):
                fl, j = self._trim_filter_pair(p1, p2, interleave=True)
                ftlP += fl
                junk += j
            ftlS = []
            for f in inS:
                p, j = self._trim_filter(f, trimq=10)
                ftlS.append(p)
                junk += j
            tecc, bbm = self._ecc_interleaved(ftlP, tadpole_k=31,
                                              extra_in=ftlS, extra_out=ftlS)
            paired = tecc
            single = [self._wd("tecc." + os.path.basename(f)) for f in ftlS]
            junk += bbm

        if not self.keep:
            self._rm(junk)
        return paired, single


def run_preprocess(bbmap_dir: str, workdir: str = ".",
                   in1: Sequence[str] = (), in2: Sequence[str] = (),
                   inP: Sequence[str] = (), inS: Sequence[str] = (),
                   threads: Optional[int] = None,
                   mem_gb: Optional[int] = None,
                   keep_intermediates: bool = False,
                   command_log: Optional[list] = None,
                   ) -> Tuple[List[str], List[str]]:
    """Convenience wrapper; returns (paired_interleaved_files, single_files)
    of error-corrected reads, the exact lists runAssembly.sh passes to
    buildG -pe/-se (runAssembly.sh:217,252,363)."""
    return Preprocessor(bbmap_dir, workdir, threads, mem_gb,
                        keep_intermediates, command_log).run(
                            in1=in1, in2=in2, inP=inP, inS=inS)
