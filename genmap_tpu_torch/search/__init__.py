"""Search schemes and the lockstep block mapper."""
