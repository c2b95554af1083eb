"""The score models of the traced sample, in s: the ns the phase-2
workers' scorers spent in them (``JOINT_STATS["genotype_ns"]`` of
``scoring/scorer``, in each record's ``counts["joint"]``: the joint
diploid genotyper of each junction and of each two-junction event),
summed over the workers. None where no record has the counter."""


def read(run):
    armed = run.get("armed")
    if not armed:
        return None
    joints = [(w.get("counts") or {}).get("joint")
              for w in armed["workers"]]
    joints = [j for j in joints if j]
    if not joints or not sum(j["sample_junctions"] for j in joints):
        return None
    return sum(j["genotype_ns"] for j in joints) / 1e9
