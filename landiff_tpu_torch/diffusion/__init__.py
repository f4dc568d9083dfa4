"""Schedules, the VPSDE-DPM++2M sampler and the stage-2 engine."""
