"""Schema-based instruction prompts, task for task.

Exact text parity with the reference agents' get_*_prompt builders
(tasks/agents/{r2r,cvdn,reverie,soon,eqa,scanqa}.py) — prompt strings
are model-behavior, so they are reproduced verbatim (SURVEY.md §4 item
3: deterministic string functions, golden-tested).

Copy of navillm_tpu/agents/prompts.py, which needs no jax: the port
cannot import it in place, because navillm_tpu/agents/__init__.py
imports the JAX runner. Keep the code in step with that file.
"""
from __future__ import annotations


def _history_block(hist_num: int) -> str:
    text = " ".join("({}) <hist>".format(i) for i in range(hist_num))
    return ("Following is the History, which contains the visual "
            "information of your previous decisions.\n"
            "### History: {}\n".format(text))


def _candidate_block(cand_num: int) -> str:
    text = " ".join("({}) <cand>".format(i) if i > 0 else "(0) stop"
                    for i in range(cand_num))
    return ("Following is the Candidate, which contains several directions "
            "you can go to at the current position, candidate (0) is stop.\n"
            "### Candidate: {}\n".format(text))


def _observation_block(cand_num: int) -> str:
    text = " ".join("({}) <cand>".format(i) for i in range(cand_num))
    return ("Following is the Observation, which contains panoramic views "
            "at your current location.\n"
            "### Candidate: {}\n".format(text))


def _object_block(cand_num: int) -> str:
    text = " ".join("({}) <cand>".format(i) if i > 0 else "(0) not exist"
                    for i in range(cand_num))
    return ("Following is the Object, which contains several objects that "
            "you could see at the current viewpoint, option (0) indicates "
            "not exist.\n"
            "### Object: {}\n".format(text))


_NAV_TASK_LINE = {
    "r2r": "### Instruction: Navigate following the instruction. {} \n",
    "r2r_aug": "### Instruction: Navigate following the instruction. {} \n",
    "cvdn": "### Instruction: Find the described room according the given "
            "dialog. Target: {} \n",
    "reverie": "### Instruction: Go to the location to complete the given "
               "task. Task: {} \n",
    "reverie_aug": "### Instruction: Go to the location to complete the "
                   "given task. Task: {} \n",
    "soon": "### Instruction: Find the described target. Target: {} \n",
    "eqa": '### Instruction: Navigate following the instruction. Move to '
           'the object in "{}", and stop there. \n',
}

_NAV_HINT = {
    "r2r": "Compare the History and Instruction to infer your current "
           "progress, and then select the correct direction from the "
           "candidates to go to the target location.\n",
    "cvdn": "Understand the dialog in the Instruction and infer the current "
            "progress based on the History and dialog. Then select the "
            "correct direction from the candidates to go to the target "
            "location.\n",
    "reverie": "Explore the scene to find out the targeted room and object. "
               "Then select the correct direction from the candidates to go "
               "to the target location.\n",
    "soon": "Nearby areas and objects can assist you in locating the "
            "desired room and object. Select the correct direction from the "
            "candidates to go to the target location.\n",
    "eqa": "Compare the History and Instruction to infer your current "
           "progress, and then select the correct direction from the "
           "candidates to go to the target location.\n",
}
_NAV_HINT["r2r_aug"] = _NAV_HINT["r2r"]
_NAV_HINT["reverie_aug"] = _NAV_HINT["reverie"]

_SUM_TASK_LINE = {
    "r2r": "### Instruction: Predict the fine-grained instruction based on "
           "your previous history and current location. Fine-grained "
           "instructions contain commands for each individual step. \n",
    "reverie": "### Instruction: Generate the task you need to complete "
               "based on your previous history and current location. \n",
    "soon": "### Instruction: Generate the target you want to find based on "
            "your previous history and current location. Describe both the "
            "target and its surroundings. \n",
}
_SUM_TASK_LINE["r2r_aug"] = _SUM_TASK_LINE["r2r"]
_SUM_TASK_LINE["reverie_aug"] = _SUM_TASK_LINE["reverie"]

_SUM_HINT = {
    "r2r": "Please generate the step-by-step instruction.\n",
    "reverie": "Please predict the task you need to complete.\n",
    "soon": "Please predict both the target you want to find and its "
            "surroundings.\n",
}
_SUM_HINT["r2r_aug"] = _SUM_HINT["r2r"]
_SUM_HINT["reverie_aug"] = _SUM_HINT["reverie"]


def navigation_prompt(task: str, instruction: str, hist_num: int,
                      cand_num: int, cls_token: str) -> str:
    base = task if task in _NAV_TASK_LINE else "r2r"
    prompt = _NAV_TASK_LINE[base].format(
        instruction.replace("?", "") if base == "eqa" else instruction)
    prompt += _history_block(hist_num)
    prompt += _candidate_block(cand_num)
    prompt += _NAV_HINT[base]
    prompt += "### Output: {}".format(cls_token)
    return prompt


def summarization_prompt(task: str, instruction: str, hist_num: int,
                         cand_num: int) -> str:
    base = task if task in _SUM_TASK_LINE else "r2r"
    prompt = _SUM_TASK_LINE[base]
    prompt += _history_block(hist_num)
    if cand_num != 0:
        prompt += _observation_block(cand_num)
    prompt += _SUM_HINT[base]
    prompt += "### Answer: "
    return prompt


def embodied_qa_prompt(task: str, instruction: str, hist_num: int,
                       cand_num: int) -> str:
    """R2R fgr2r variant vs EQA variant (r2r.py:53-68, eqa.py:33-48)."""
    if task == "eqa":
        prompt = "### Instruction: Answer the question according to the scene. \n"
        prompt += _history_block(hist_num)
        if cand_num != 0:
            prompt += _observation_block(cand_num)
    else:
        prompt = "### Instruction: answer the question. \n"
        if hist_num != 0:
            prompt += _history_block(hist_num)
        if cand_num != 0:
            prompt += _observation_block(cand_num)
    prompt += "### Question: {}\n".format(instruction)
    prompt += "### Answer: "
    return prompt


def object_grounding_prompt(task: str, instruction: str, hist_num: int,
                            cand_num: int, cls_token: str) -> str:
    base = "reverie" if task.startswith("reverie") else "soon"
    prompt = ("Select the target object from the candidate objects based on "
              "the instruction and history.\n")
    prompt += _NAV_TASK_LINE[base].format(instruction)
    prompt += _history_block(hist_num)
    prompt += _object_block(cand_num)
    prompt += ("Select the target object from the candidate objects "
               "according to the instruction.\n")
    prompt += "### Output: {}".format(cls_token)
    return prompt


def llava_3dqa_prompt(question: str, cand_num: int) -> str:
    """LLaVA single-image prompt (tasks/agents/llava.py:13-18)."""
    return ("### Image: <cand>\n"
            "### Instruction: {}\n".format(question)
            + "### Output: ")


def threedqa_prompt(question: str, cand_num: int) -> str:
    """ScanQA/LLaVA 3dqa prompt (scanqa.py:13-20)."""
    obs_text = " ".join("({}) <cand>".format(i) for i in range(cand_num))
    return ("Please answer questions based on the observation.\n"
            "The following is the Observation, which includes multiple "
            "images from different locations.\n"
            "### Observation: {} \n".format(obs_text)
            + "### Question: {}\n".format(question)
            + "### Answer: ")
