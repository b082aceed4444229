from .profiling import device_trace, profile_section, profiler_summary, time_function

__all__ = ["device_trace", "profile_section", "profiler_summary", "time_function"]
