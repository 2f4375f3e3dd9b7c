"""The plain reference and the frozen PD-2014 tables it reads."""
