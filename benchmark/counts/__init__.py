"""Operation and byte counts of the work an env step and a PPO iteration
need, as functions of shapes only. They stay the same whatever
implements the work, so a roofline or peak share read against them
moves only when the time does."""
