"""Core library: the paper's contribution (FAQ) plus RTN/AWQ baselines."""
from .quantizer import (QuantSpec, QuantizedTensor, dequantize_groupwise,
                        effective_group_size, pack_codes, quant_dequant,
                        quantize_groupwise, storage_bits, unpack_codes)
from .methods import (DEFAULT_ALPHA_GRID, PRESEARCHED_GAMMA,
                      PRESEARCHED_WINDOW, SearchResult, candidate_scale,
                      full_search_faq, fuse_stats, normalize_scale,
                      quant_error, search_alpha, search_alpha_plain,
                      site_stat_for_method, window_preview)
from .calibration import run_calibration
from .apply import quantize_model, report_summary
from .stats import site_stat, merge_stats

__all__ = [
    "QuantSpec", "QuantizedTensor", "dequantize_groupwise",
    "effective_group_size", "pack_codes", "quant_dequant",
    "quantize_groupwise", "storage_bits", "unpack_codes",
    "DEFAULT_ALPHA_GRID", "PRESEARCHED_GAMMA", "PRESEARCHED_WINDOW",
    "SearchResult", "candidate_scale", "fuse_stats", "normalize_scale",
    "full_search_faq", "quant_error", "search_alpha", "search_alpha_plain",
    "site_stat_for_method", "window_preview",
    "run_calibration", "quantize_model", "report_summary",
    "site_stat", "merge_stats",
]
