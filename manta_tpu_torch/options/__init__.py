"""Central registry of typed option defaults.

The reference collects every binary's boost::program_options structs
under src/c++/lib/options/ (ReadScannerOptions, SVLocusSetOptions,
SVRefinerOptions, IterativeAssemblerOptions, CallOptionsDiploid/
Somatic/Tumor/Shared, AlignmentFileOptions). Here each option
dataclass lives next to the layer it configures; this package
re-exports them all so the full default surface is one import away:

    from manta_tpu_torch.options import ScannerOptions, CallOptionsSomatic

The user-facing tiers on top of these defaults are the workflow CLI
(workflow/config.py, mirroring configManta.py) and the advanced ini
(workflow/config_defaults.ini + ADVANCED_DEFAULTS in workflow/run.py,
mirroring configManta.py.ini).
"""

from ..assembly.assembler import AssemblerOptions
from ..assembly.small_assembler import SmallAssemblerOptions
from ..candidates.processor import ProcessorOptions
from ..candidates.refiner import RefinerOptions
from ..graph.locusgraph import SVLocusSetOptions
from ..scan.scanner import ScannerOptions
from ..scoring.pairscore import PairOptions
from ..scoring.scorer import (
    CallOptionsDiploid, CallOptionsSomatic, CallOptionsTumor,
)

__all__ = [
    "AssemblerOptions", "SmallAssemblerOptions", "ProcessorOptions",
    "RefinerOptions", "SVLocusSetOptions", "ScannerOptions",
    "PairOptions", "CallOptionsDiploid", "CallOptionsSomatic",
    "CallOptionsTumor",
]
