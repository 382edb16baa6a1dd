"""Reference-name registry aliases.

The reference registers blocks under names like ``gr::blocks::sdr::SoapySource``
or ``gr::electrical::ThreePhasePowerMetrics`` (GR_REGISTER_BLOCK sites across
blocks/*/); ``load_grc`` strips the namespace/template decoration down to the
base name (yaml_io._strip_reference_id). This module registers those base names
as factories over our equivalents — with the reference variant's fixed
parameters applied as overridable defaults — so a flowgraph saved by the
reference instantiates directly here.

Type-parameter expansions (``Multiply<float>`` …) need no aliases: dtypes are
resolved per-edge at compile time. Phase-count variants need none either
(phase count follows the input's channel dimension), but the names must exist
for GRC loading.
"""

from __future__ import annotations

from ..core.registry import global_registry as _reg


def _alias(name: str, target: str, **preset) -> None:
    factory = _reg.get(target)

    def make(**settings):
        return factory(**{**preset, **settings})

    make.__name__ = name
    make.__doc__ = (f"Reference-name alias for {target}"
                    + (f" with defaults {preset}" if preset else ""))
    _reg.add(name, make)


# sdr — SoapySource.hpp:27 / SoapySink.hpp:18 / RTL2832Device.hpp
_alias("SoapySource", "SdrSource", driver="soapy")
_alias("SoapySink", "SdrSink", driver="soapy")
_alias("SoapyDualSource", "SdrSource", driver="soapy", channels=2)
_alias("SoapyQuadSource", "SdrSource", driver="soapy", channels=4)
_alias("SoapyDualSink", "SdrSink", driver="soapy")
_alias("SoapyQuadSink", "SdrSink", driver="soapy")
_alias("RTL2832Source", "SdrSource", driver="rtlsdr")

# electrical — PowerEstimators.hpp registers per-phase-count instantiations;
# here the phase count is the input's channel dimension
_alias("SinglePhasePowerMetrics", "PowerMetrics")
_alias("ThreePhasePowerMetrics", "PowerMetrics")
_alias("SinglePhasePowerFactorCalculator", "PowerFactor")
_alias("ThreePhasePowerFactorCalculator", "PowerFactor")
_alias("TwoPhaseSystemUnbalanceCalculator", "SystemUnbalance")
_alias("ThreePhaseSystemUnbalanceCalculator", "SystemUnbalance")

# filter — FrequencyEstimator.hpp time/frequency-domain (+decimating) variants;
# ours estimates per chunk (inherently decimating) with a method switch
_alias("FrequencyEstimatorTimeDomain", "FrequencyEstimator",
       method="zero_crossing")
_alias("FrequencyEstimatorTimeDomainDecimating", "FrequencyEstimator",
       method="zero_crossing")
_alias("FrequencyEstimatorFrequencyDomain", "FrequencyEstimator", method="fft")
_alias("FrequencyEstimatorFrequencyDomainDecimating", "FrequencyEstimator",
       method="fft")

# fileio — BasicFileIo.hpp
_alias("BasicFileSource", "FileSource")
_alias("BasicFileSink", "FileSink")

# converters — ConverterBlocks.hpp
_alias("Real", "ComplexToReal")
_alias("Imag", "ComplexToImag")
_alias("DegreeToRadians", "DegToRad")
_alias("RadiansToDegree", "RadToDeg")


def _alias_map(name: str, target: str, keymap: dict[str, str],
               **preset) -> None:
    """Alias that also renames settings keys (reference name → ours)."""
    factory = _reg.get(target)

    def make(**settings):
        mapped = {keymap.get(k, k): v for k, v in settings.items()}
        return factory(**{**preset, **mapped})

    make.__name__ = name
    make.__doc__ = (f"Reference-name alias for {target}, settings keymap "
                    f"{keymap}")
    _reg.add(name, make)


# time-domain filters — time_domain_filter.hpp:24 fir_filter / :57-60
# iir_filter (all four IIRForm registrations collapse onto the scan engine:
# DF-I/II/transposed are algebraically identical transfer functions; form
# choice is a CPU micro-arch concern with no device analog)
_alias("fir_filter", "FirFilter")
_alias("iir_filter", "IirFilter")

# CommonBlocks.hpp: builtin_multiply{factor} / builtin_counter (pass-through
# + work-event count; stream behavior = Copy)
_alias_map("builtin_multiply", "MultiplyConst", {"factor": "value"})
_alias("builtin_counter", "Copy")

# ImChartMonitor.hpp:19 registers the chart-less variant as ConsoleDebugSink
_alias("ConsoleDebugSink", "ImChartMonitor")

# Trigger.hpp SchmittTrigger interpolation-method variants
_alias("SchmittTriggerBasic", "SchmittTrigger", interpolation="basic_linear")
_alias("SchmittTriggerNoInterpolation", "SchmittTrigger",
       interpolation="none")
_alias("SchmittTriggerPolynomial", "SchmittTrigger",
       interpolation="polynomial")

# FilterTool-designed filter prototype name (BasicFilterProto)
_alias("BasicFilterProto", "BasicFilter")
