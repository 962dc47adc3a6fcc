"""MOD dataset extraction constants: per-recording trim tables and folder
allowlists.

These are measured dataset constants (seconds to drop at the start/end of
each raw recording, and which run/sensor folders are clean enough to use) —
they must match the reference bit-for-bit or the extracted dataset differs
(reference: src/data_preprocess/MOD/data_trunk.py:1-58,
extract_samples.py:39-64, extract_pretrain_samples.py:37-51).

Reference quirk preserved: data_trunk.py defines the "tesla" key TWICE in
both dicts; Python keeps the later literal, so the effective trims are the
second entries (start 90/80/80/90, end 90/90/90/80) and the first entries
are dead. We ship only the effective values.
"""

# seconds trimmed from the start of each (run, sensor) recording
START_TIME_SHIFT = {
    "bicycle": {"rs1": 0, "rs2": 0, "rs3": 0, "rs7": 0},
    "bicycle2": {"rs1": 160, "rs2": 130, "rs3": 100, "rs7": 100},
    "forester": {"rs1": 170, "rs2": 140, "rs3": 170, "rs7": 180},
    "forester2": {"rs1": 95, "rs2": 85, "rs3": 90, "rs7": 75},
    "motor": {"rs1": 160, "rs2": 160, "rs3": 160, "rs7": 160},
    "motor2": {"rs1": 240, "rs2": 225, "rs3": 240, "rs7": 240},
    "mustang": {"rs1": 380, "rs2": 360, "rs3": 370, "rs7": 350},
    "mustang2": {"rs1": 70, "rs2": 70, "rs3": 75, "rs7": 75},
    "pickup": {"rs1": 330, "rs2": 290, "rs3": 260, "rs7": 290},
    "pickup2": {"rs1": 135, "rs2": 135, "rs3": 125, "rs7": 120},
    "scooter": {"rs1": 150, "rs2": 150, "rs3": 140, "rs7": 90},
    "scooter2": {"rs1": 150, "rs2": 180, "rs3": 170, "rs7": 180},
    # effective "tesla" row (second literal wins in the reference)
    "tesla": {"rs1": 90, "rs2": 80, "rs3": 80, "rs7": 90},
    "mustang0528": {"rs1": 300, "rs2": 300, "rs3": 300, "rs7": 300},
    "walk": {"rs1": 60, "rs2": 60, "rs3": 60, "rs7": 60},
    "walk2": {"rs1": 60, "rs2": 60, "rs3": 60, "rs7": 60},
    "Warhog1135am": {"rs1": 0},
    "Warhog1149am": {"rs1": 0},
    "Warhog1209am": {"rs1": 0},
    "Warhog-NoLineOfSight": {"rs1": 0},
    "Polaris0150pm": {"rs1": 0},
    "Polaris0215pm": {"rs1": 0},
    "Polaris0235pm-NoLineOfSight": {"rs1": 0},
    "Silverado0255pm": {"rs1": 0},
    "Silverado0315pm": {"rs1": 0},
}

# seconds trimmed from the end of each (run, sensor) recording
END_TIME_SHIFT = {
    "bicycle": {"rs1": 0, "rs2": 0, "rs3": 0, "rs7": 0},
    "bicycle2": {"rs1": 120, "rs2": 90, "rs3": 90, "rs7": 150},
    "forester": {"rs1": 80, "rs2": 100, "rs3": 100, "rs7": 80},
    "forester2": {"rs1": 90, "rs2": 60, "rs3": 60, "rs7": 80},
    "motor": {"rs1": 100, "rs2": 80, "rs3": 65, "rs7": 90},
    "motor2": {"rs1": 100, "rs2": 80, "rs3": 90, "rs7": 70},
    "mustang": {"rs1": 30, "rs2": 40, "rs3": 30, "rs7": 30},
    "mustang2": {"rs1": 40, "rs2": 30, "rs3": 35, "rs7": 40},
    "pickup": {"rs1": 130, "rs2": 110, "rs3": 70, "rs7": 30},
    "pickup2": {"rs1": 120, "rs2": 100, "rs3": 95, "rs7": 45},
    "scooter": {"rs1": 120, "rs2": 60, "rs3": 60, "rs7": 20},
    "scooter2": {"rs1": 50, "rs2": 75, "rs3": 60, "rs7": 90},
    # effective "tesla" row (second literal wins in the reference)
    "tesla": {"rs1": 90, "rs2": 90, "rs3": 90, "rs7": 80},
    "mustang0528": {"rs1": 60, "rs2": 60, "rs3": 60, "rs7": 60},
    "walk": {"rs1": 60, "rs2": 60, "rs3": 60, "rs7": 60},
    "walk2": {"rs1": 60, "rs2": 60, "rs3": 60, "rs7": 60},
    "Warhog1135am": {"rs1": 0},
    "Warhog1149am": {"rs1": 0},
    "Warhog1209am": {"rs1": 0},
    "Warhog-NoLineOfSight": {"rs1": 0},
    "Polaris0150pm": {"rs1": 0},
    "Polaris0215pm": {"rs1": 0},
    "Polaris0235pm-NoLineOfSight": {"rs1": 0},
    "Silverado0255pm": {"rs1": 0},
    "Silverado0315pm": {"rs1": 0},
}

# sensor folders used for the labeled (train/val/test) extraction
SUBJECTS = {"rs3"}

# run folders used for the labeled extraction (extract_samples.py:40-53)
PRESERVED_CLEAN_FOLDERS = {
    "motor",
    "mustang0528",
    "walk2",
    "tesla",
    "Polaris0150pm",
    "Polaris0215pm",
    "Polaris0235pm-NoLineOfSight",
    "Warhog1135am",
    "Warhog1149am",
    "Warhog-NoLineOfSight",
    "Silverado0255pm",
    "Silverado0315pm",
}

# run folders that only carry an "rs1" sensor (extract_samples.py:55-64)
PRESERVED_CLEAN_FOLDERS_2 = {
    "Polaris0150pm",
    "Polaris0215pm",
    "Polaris0235pm-NoLineOfSight",
    "Warhog1135am",
    "Warhog1149am",
    "Warhog-NoLineOfSight",
    "Silverado0255pm",
    "Silverado0315pm",
}

# {run folder: sensor folders} for the unlabeled "extra" pretrain extraction
# (extract_pretrain_samples.py:37-51)
PRESERVED_EXTRA_FOLDERS = {
    "motor": ["rs1", "rs2", "rs7"],
    "mustang0528": ["rs1", "rs2", "rs7"],
    "walk2": ["rs1", "rs2", "rs7"],
    "tesla": ["rs1", "rs2", "rs7"],
    "bicycle": ["rs1", "rs2", "rs3", "rs7"],
    "bicycle2": ["rs1", "rs2", "rs3", "rs7"],
    "forester": ["rs1", "rs2", "rs3", "rs7"],
    "forester2": ["rs1", "rs2", "rs3", "rs7"],
    "motor2": ["rs1", "rs2", "rs3", "rs7"],
    "pickup": ["rs1", "rs2", "rs3", "rs7"],
    "pickup2": ["rs1", "rs2", "rs3", "rs7"],
    "scooter": ["rs1", "rs2", "rs3", "rs7"],
    "scooter2": ["rs1", "rs2", "rs3", "rs7"],
    "walk": ["rs1", "rs2", "rs3", "rs7"],
}


def default_shift(run_folder, shake):
    """(start_s, end_s) trim for a recording; 0 for unknown folders (the
    reference hard-KeyErrors instead — softened so synthetic layouts work)."""
    return (
        START_TIME_SHIFT.get(run_folder, {}).get(shake, 0),
        END_TIME_SHIFT.get(run_folder, {}).get(shake, 0),
    )
